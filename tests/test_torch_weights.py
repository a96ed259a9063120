"""The port's ``load_clip_weights(path, config)`` against the JAX package's
on the same files.

A tiny random ``transformers.CLIPModel`` at TINY_TEST's geometry (built
offline, as tests/test_parity_torch.py builds its oracle; every tensor of its
state dict refilled from a seeded numpy generator, so that each transpose,
fusion and stack is seen) is written in every format the JAX loader reads:
a ``.npz`` of the JAX tree, HF and OpenAI-layout ``.pt``/``.pth`` state
dicts, an OpenAI-layout TorchScript archive (the form of ``clip.load``'s
files), and HF checkpoint directories with ``model.safetensors`` or
``pytorch_model.bin``. The port's tree must equal JAX's exactly, key for
key, after ``flatten_params``. The loader never unpickles objects: every
``torch.load`` it makes asks for ``weights_only=True``.
"""

import inspect
import warnings

import numpy as np
import pytest
import torch

from aiic_tpu.models.config import TINY_TEST as JAX_TINY
from aiic_tpu.models.init import flatten_params as jax_flatten
from aiic_tpu.models.init import from_hf_clip_state_dict as jax_from_hf
from aiic_tpu.models.init import load_clip_weights as jax_load
from aiic_tpu.models.init import save_clip_weights as jax_save
from aiic_tpu_torch.models import init
from aiic_tpu_torch.models.config import TINY_TEST
from aiic_tpu_torch.models.init import flatten_params, load_clip_weights

torch.set_num_threads(2)

FORMATS = ["npz", "hf_pt", "openai_pth", "openai_torchscript", "hf_dir_safetensors",
           "hf_dir_bin"]


def _hf_model():
    from transformers import CLIPConfig, CLIPModel

    c = TINY_TEST
    tower = lambda t: dict(hidden_size=t.width, intermediate_size=t.mlp_dim,  # noqa: E731
                           num_hidden_layers=t.layers, num_attention_heads=t.heads,
                           hidden_act="quick_gelu")
    cfg = CLIPConfig(text_config=dict(tower(c.text), max_position_embeddings=c.context_length,
                                      vocab_size=c.vocab_size),
                     vision_config=dict(tower(c.vision), image_size=c.image_size,
                                        patch_size=c.patch_size),
                     projection_dim=c.embed_dim)
    model = CLIPModel(cfg).eval()
    rng = np.random.default_rng(40)
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.is_floating_point():
                t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    return model


def _openai_sd(sd):
    """The OpenAI ``clip``-package layout of the same weights."""
    out = {}
    for hf, oa, layers in (("vision_model", "visual.transformer", TINY_TEST.vision.layers),
                           ("text_model", "transformer", TINY_TEST.text.layers)):
        for i in range(layers):
            h, o = f"{hf}.encoder.layers.{i}", f"{oa}.resblocks.{i}"
            for kind in ("weight", "bias"):
                out[f"{o}.attn.in_proj_{kind}"] = torch.cat(
                    [sd[f"{h}.self_attn.{n}_proj.{kind}"] for n in "qkv"])
                for a, b in (("attn.out_proj", "self_attn.out_proj"), ("ln_1", "layer_norm1"),
                             ("ln_2", "layer_norm2"), ("mlp.c_fc", "mlp.fc1"),
                             ("mlp.c_proj", "mlp.fc2")):
                    out[f"{o}.{a}.{kind}"] = sd[f"{h}.{b}.{kind}"]
    out.update({
        "visual.conv1.weight": sd["vision_model.embeddings.patch_embedding.weight"],
        "visual.class_embedding": sd["vision_model.embeddings.class_embedding"],
        "visual.positional_embedding": sd["vision_model.embeddings.position_embedding.weight"],
        "visual.ln_pre.weight": sd["vision_model.pre_layrnorm.weight"],
        "visual.ln_pre.bias": sd["vision_model.pre_layrnorm.bias"],
        "visual.ln_post.weight": sd["vision_model.post_layernorm.weight"],
        "visual.ln_post.bias": sd["vision_model.post_layernorm.bias"],
        "visual.proj": sd["visual_projection.weight"].t().contiguous(),
        "token_embedding.weight": sd["text_model.embeddings.token_embedding.weight"],
        "positional_embedding": sd["text_model.embeddings.position_embedding.weight"],
        "ln_final.weight": sd["text_model.final_layer_norm.weight"],
        "ln_final.bias": sd["text_model.final_layer_norm.bias"],
        "text_projection": sd["text_projection.weight"].t().contiguous(),
        "logit_scale": sd["logit_scale"],
    })
    return out


class _Holder(torch.nn.Module):
    """A scriptable module whose state dict is a given flat dict."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _torchscript(sd, path):
    root = _Holder()
    for key, t in sd.items():
        *parents, leaf = key.split(".")
        node = root
        for p in parents:
            if not hasattr(node, p):
                node.add_module(p, torch.nn.Module())
            node = getattr(node, p)
        node.register_parameter(leaf, torch.nn.Parameter(t.clone(), requires_grad=False))
    torch.jit.save(torch.jit.script(root), path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    model = _hf_model()
    sd = {k: v for k, v in model.state_dict().items() if v.is_floating_point()}
    paths = {f: str(root / name) for f, name in (
        ("npz", "w.npz"), ("hf_pt", "hf.pt"), ("openai_pth", "openai.pth"),
        ("openai_torchscript", "openai_jit.pt"), ("hf_dir_safetensors", "hf_st"),
        ("hf_dir_bin", "hf_bin"))}
    jax_save(jax_from_hf(sd, JAX_TINY), paths["npz"])
    torch.save(sd, paths["hf_pt"])
    torch.save(_openai_sd(sd), paths["openai_pth"])
    _torchscript(_openai_sd(sd), paths["openai_torchscript"])
    model.save_pretrained(paths["hf_dir_safetensors"], safe_serialization=True)
    model.save_pretrained(paths["hf_dir_bin"], safe_serialization=False)
    return paths


@pytest.mark.parametrize("fmt", FORMATS)
def test_load_clip_weights_equals_jax(files, fmt, monkeypatch):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # torch.load's note on TorchScript archives
        ref = jax_flatten(jax_load(files[fmt], JAX_TINY))
    real_load = torch.load

    def safe_load(*args, **kw):
        assert kw.get("weights_only") is True, "the port unpickled objects"
        return real_load(*args, **kw)

    monkeypatch.setattr(torch, "load", safe_load)
    ours = flatten_params(load_clip_weights(files[fmt], TINY_TEST))
    assert sorted(ours) == sorted(ref)
    for key, value in ours.items():
        assert value.dtype == np.float32, key
        np.testing.assert_array_equal(value, np.asarray(ref[key]), err_msg=key)


def test_load_clip_weights_device_and_dtype(files):
    sig = inspect.signature(load_clip_weights).parameters
    assert list(sig)[:2] == ["path", "config"]
    assert all(sig[k].kind is inspect.Parameter.KEYWORD_ONLY for k in ("device", "dtype"))
    tree = load_clip_weights(files["hf_pt"], TINY_TEST, dtype=torch.bfloat16)
    leaves = []
    init.tree_map(leaves.append, tree)
    assert leaves and all(t.dtype == torch.bfloat16 for t in leaves)
    ours = flatten_params(init.tree_map(torch.Tensor.float, tree))
    ref = jax_flatten(jax_from_hf(torch.load(files["hf_pt"], weights_only=True), JAX_TINY))
    assert sorted(ours) == sorted(ref)
    for key, value in ours.items():
        want = torch.from_numpy(np.asarray(ref[key])).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(value, want, err_msg=key)


def test_openai_layout_is_told_by_conv1(tmp_path, files):
    """A state dict with ``visual.conv1.weight`` takes the OpenAI converter
    (a partial one raises KeyError there, as in the JAX package, rather
    than passing to the HF one); the TorchScript archive is told apart from
    a plain state dict by its archive, not by unpickling it."""
    sd = torch.load(files["hf_pt"], weights_only=True)
    path = str(tmp_path / "partial.pt")
    torch.save({"visual.conv1.weight": sd["vision_model.embeddings.patch_embedding.weight"]}, path)
    with pytest.raises(KeyError):
        load_clip_weights(path, TINY_TEST)
    with pytest.raises(KeyError):
        jax_load(path, JAX_TINY)
    assert init._is_torchscript(files["openai_torchscript"])
    assert not any(init._is_torchscript(files[f]) for f in ("hf_pt", "openai_pth", "npz"))
