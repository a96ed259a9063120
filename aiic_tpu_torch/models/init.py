"""Parameter initialization and the weight bridge from the JAX package.

The port keeps the JAX package's public layout: nested dicts of tensors, all
linear weights stored (in, out), ``wqkv`` as (W, 3W) with [Q | K | V]
columns, ``patch_embed`` as (3·p·p, W) flattened channel-major, and each
tower's blocks stacked on a leading layer axis.

- ``params_from_numpy`` takes the flat dict that
  ``aiic_tpu.models.init.flatten_params`` produces (numpy arrays keyed
  ``visual/blocks/attn/wqkv`` …, the layout of ``save_clip_weights`` npz
  files) and returns the port's tree on a device and dtype. A flattened
  LoRA adapter tree (``c_fc/A`` …) comes across the same way.
- ``load_clip_weights(path, config)`` has the JAX package's signature and
  formats: such an npz, a ``.pt``/``.pth`` state dict in the OpenAI ``clip``
  layout (told apart by ``visual.conv1.weight``, as the JAX loader does) or
  the HuggingFace ``CLIPModel`` layout, or an HF checkpoint directory
  (``model.safetensors`` or ``pytorch_model.bin``). ``from_openai_clip_state_dict``
  and ``from_hf_clip_state_dict`` are numpy copies of the JAX converters.
  Plain state dicts load with ``weights_only=True``; a TorchScript archive
  (OpenAI's ``clip.load`` files) through ``torch.jit.load``, never by
  unpickling arbitrary objects.
- ``init_clip_params`` reproduces the shapes and distributions of the JAX
  package's OpenAI-CLIP init with a ``torch.Generator``. It does not
  reproduce JAX's random bits: tests that compare the two packages make the
  weights once and hand them to both through ``params_from_numpy``.
"""

from __future__ import annotations

import math
import os
import zipfile
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from aiic_tpu_torch.models.config import CLIPConfig

Params = Dict[str, Any]


def _ln(width: int, device) -> Params:
    return {"scale": torch.ones(width, device=device),
            "bias": torch.zeros(width, device=device)}


def _normal(gen: torch.Generator, shape, std: float, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device) * std


def _init_tower_blocks(gen, layers: int, width: int, mlp_dim: int, device) -> Params:
    """Stacked (leading layer axis) block params, OpenAI CLIP init scheme."""
    attn_std = width ** -0.5
    proj_std = (width ** -0.5) * ((2 * layers) ** -0.5)
    fc_std = (2 * width) ** -0.5
    zeros = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    ones = lambda *s: torch.ones(s, device=device)  # noqa: E731
    return {
        "ln1": {"scale": ones(layers, width), "bias": zeros(layers, width)},
        "ln2": {"scale": ones(layers, width), "bias": zeros(layers, width)},
        "attn": {
            "wqkv": _normal(gen, (layers, width, 3 * width), attn_std, device),
            "bqkv": zeros(layers, 3 * width),
            "wo": _normal(gen, (layers, width, width), proj_std, device),
            "bo": zeros(layers, width),
        },
        "mlp": {
            "w1": _normal(gen, (layers, width, mlp_dim), fc_std, device),
            "b1": zeros(layers, mlp_dim),
            "w2": _normal(gen, (layers, mlp_dim, width), proj_std, device),
            "b2": zeros(layers, width),
        },
    }


def init_clip_params(config: CLIPConfig, generator: torch.Generator,
                     device="cpu") -> Params:
    """Random float32 CLIP params with the JAX package's shapes and
    distributions (``aiic_tpu.models.init.init_clip_params``). ``generator``
    must live on ``device``."""
    vw, tw = config.vision.width, config.text.width
    patch_dim = 3 * config.patch_size * config.patch_size
    vscale = vw ** -0.5
    tscale = tw ** -0.5
    g = generator
    return {
        "visual": {
            "patch_embed": _normal(g, (patch_dim, vw), vscale, device),
            "cls": _normal(g, (vw,), vscale, device),
            "pos": _normal(g, (config.vision_seq_len, vw), vscale, device),
            "ln_pre": _ln(vw, device),
            "blocks": _init_tower_blocks(g, config.vision.layers, vw,
                                         config.vision.mlp_dim, device),
            "ln_post": _ln(vw, device),
            "proj": _normal(g, (vw, config.embed_dim), vscale, device),
        },
        "text": {
            "tok_embed": _normal(g, (config.vocab_size, tw), 0.02, device),
            "pos": _normal(g, (config.context_length, tw), 0.01, device),
            "blocks": _init_tower_blocks(g, config.text.layers, tw,
                                         config.text.mlp_dim, device),
            "ln_final": _ln(tw, device),
            "proj": _normal(g, (tw, config.embed_dim), tscale, device),
        },
        "logit_scale": torch.tensor(math.log(1.0 / 0.07), device=device),
    }


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(flat: Mapping[str, np.ndarray], device="cpu",
                      dtype: Optional[torch.dtype] = torch.float32) -> Params:
    """Flat ``{"a/b/c": ndarray}`` (``aiic_tpu.models.init.flatten_params``)
    -> nested dict of tensors on ``device``. Floating leaves are cast to
    ``dtype`` (``None`` keeps them); integer leaves keep their type."""
    tree: Params = {}
    for key, value in flat.items():
        t = torch.from_numpy(np.array(value))  # a writable copy; keeps 0-d leaves
        if t.is_floating_point() and dtype is not None:
            t = t.to(dtype)
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.to(device)
    return tree


def flatten_params(params: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict of tensors -> flat ``{"a/b/c": ndarray}`` (the npz layout)."""
    flat = {}
    if isinstance(params, Mapping):
        for k, v in params.items():
            flat.update(flatten_params(v, f"{prefix}{k}/"))
    else:
        flat[prefix.rstrip("/")] = params.detach().cpu().numpy()
    return flat


def _np(t) -> np.ndarray:
    """A tensor or array-like as a float32 numpy array (the JAX converters'
    ``_np``)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


_BLOCK_KEYS = {  # tower leaf -> (OpenAI key, HF key) under a block's prefix; linears transposed
    "ln1/scale": ("ln_1.weight", "layer_norm1.weight"),
    "ln1/bias": ("ln_1.bias", "layer_norm1.bias"),
    "ln2/scale": ("ln_2.weight", "layer_norm2.weight"),
    "ln2/bias": ("ln_2.bias", "layer_norm2.bias"),
    "attn/wo": ("attn.out_proj.weight", "self_attn.out_proj.weight"),
    "attn/bo": ("attn.out_proj.bias", "self_attn.out_proj.bias"),
    "mlp/w1": ("mlp.c_fc.weight", "mlp.fc1.weight"),
    "mlp/b1": ("mlp.c_fc.bias", "mlp.fc1.bias"),
    "mlp/w2": ("mlp.c_proj.weight", "mlp.fc2.weight"),
    "mlp/b2": ("mlp.c_proj.bias", "mlp.fc2.bias"),
}


def _tower(sd: Mapping[str, Any], prefix: str, layers: int, hf: bool) -> Dict[str, np.ndarray]:
    """A tower's stacked block leaves ``blocks/...`` from an OpenAI
    (``{prefix}.resblocks.i``) or HF (``{prefix}.encoder.layers.i``) state
    dict; the fused (W, 3W) [Q|K|V] projection from OpenAI's in_proj or HF's
    separate q/k/v."""
    stacks: Dict[str, list] = {}
    for i in range(layers):
        p = f"{prefix}.encoder.layers.{i}" if hf else f"{prefix}.resblocks.{i}"
        leaves = {}
        for leaf, keys in _BLOCK_KEYS.items():
            a = _np(sd[f"{p}.{keys[hf]}"])
            leaves[leaf] = a.T if a.ndim == 2 else a
        if hf:
            leaves["attn/wqkv"] = np.concatenate(
                [_np(sd[f"{p}.self_attn.{n}_proj.weight"]).T for n in "qkv"], axis=1)
            leaves["attn/bqkv"] = np.concatenate(
                [_np(sd[f"{p}.self_attn.{n}_proj.bias"]) for n in "qkv"], axis=0)
        else:
            leaves["attn/wqkv"] = _np(sd[f"{p}.attn.in_proj_weight"]).T
            leaves["attn/bqkv"] = _np(sd[f"{p}.attn.in_proj_bias"])
        for leaf, a in leaves.items():
            stacks.setdefault(leaf, []).append(a)
    return {f"blocks/{leaf}": np.stack(arrs, axis=0) for leaf, arrs in stacks.items()}


def _convert(flat: Dict[str, np.ndarray], visual: Dict[str, np.ndarray],
             text: Dict[str, np.ndarray], device, dtype) -> Params:
    flat.update({f"visual/{k}": v for k, v in visual.items()})
    flat.update({f"text/{k}": v for k, v in text.items()})
    return params_from_numpy(flat, device=device, dtype=dtype)


def from_hf_clip_state_dict(sd: Mapping[str, Any], config: CLIPConfig, *, device="cpu",
                            dtype: Optional[torch.dtype] = torch.float32) -> Params:
    """A HuggingFace ``transformers.CLIPModel`` state dict as the port's tree
    (``aiic_tpu.models.init.from_hf_clip_state_dict``): separate q/k/v
    projections in torch's (out, in) layout fused into (W, 3W) [Q|K|V]."""
    conv = _np(sd["vision_model.embeddings.patch_embedding.weight"])  # (W, 3, p, p)
    vm, tm = "vision_model", "text_model"
    visual = {
        "patch_embed": conv.reshape(conv.shape[0], -1).T,  # (3*p*p, W) channel-major
        "cls": _np(sd[f"{vm}.embeddings.class_embedding"]),
        "pos": _np(sd[f"{vm}.embeddings.position_embedding.weight"]),
        "ln_pre/scale": _np(sd[f"{vm}.pre_layrnorm.weight"]),
        "ln_pre/bias": _np(sd[f"{vm}.pre_layrnorm.bias"]),
        **_tower(sd, vm, config.vision.layers, hf=True),
        "ln_post/scale": _np(sd[f"{vm}.post_layernorm.weight"]),
        "ln_post/bias": _np(sd[f"{vm}.post_layernorm.bias"]),
        "proj": _np(sd["visual_projection.weight"]).T,
    }
    text = {
        "tok_embed": _np(sd[f"{tm}.embeddings.token_embedding.weight"]),
        "pos": _np(sd[f"{tm}.embeddings.position_embedding.weight"]),
        **_tower(sd, tm, config.text.layers, hf=True),
        "ln_final/scale": _np(sd[f"{tm}.final_layer_norm.weight"]),
        "ln_final/bias": _np(sd[f"{tm}.final_layer_norm.bias"]),
        "proj": _np(sd["text_projection.weight"]).T,
    }
    return _convert({"logit_scale": _np(sd["logit_scale"])}, visual, text, device, dtype)


def from_openai_clip_state_dict(sd: Mapping[str, Any], config: CLIPConfig, *, device="cpu",
                                dtype: Optional[torch.dtype] = torch.float32) -> Params:
    """An OpenAI ``clip`` package state dict as the port's tree
    (``aiic_tpu.models.init.from_openai_clip_state_dict``): ``in_proj_weight``
    (3W, W) in [Q;K;V] row order transposes to the (W, 3W) column layout."""
    conv = _np(sd["visual.conv1.weight"])  # (W, 3, p, p)
    visual = {
        "patch_embed": conv.reshape(conv.shape[0], -1).T,
        "cls": _np(sd["visual.class_embedding"]),
        "pos": _np(sd["visual.positional_embedding"]),
        "ln_pre/scale": _np(sd["visual.ln_pre.weight"]),
        "ln_pre/bias": _np(sd["visual.ln_pre.bias"]),
        **_tower(sd, "visual.transformer", config.vision.layers, hf=False),
        "ln_post/scale": _np(sd["visual.ln_post.weight"]),
        "ln_post/bias": _np(sd["visual.ln_post.bias"]),
        "proj": _np(sd["visual.proj"]),  # already (W, embed)
    }
    text = {
        "tok_embed": _np(sd["token_embedding.weight"]),
        "pos": _np(sd["positional_embedding"]),
        **_tower(sd, "transformer", config.text.layers, hf=False),
        "ln_final/scale": _np(sd["ln_final.weight"]),
        "ln_final/bias": _np(sd["ln_final.bias"]),
        "proj": _np(sd["text_projection"]),  # already (W, embed)
    }
    return _convert({"logit_scale": _np(sd["logit_scale"])}, visual, text, device, dtype)


def _is_torchscript(path: str) -> bool:
    """Whether ``path`` is a TorchScript archive (a zip with constants.pkl),
    as OpenAI's ``clip.load`` files are."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n == "constants.pkl" or n.endswith("/constants.pkl") for n in z.namelist())


def load_clip_weights(path: str, config: CLIPConfig, *, device="cpu",
                      dtype: Optional[torch.dtype] = torch.float32) -> Params:
    """CLIP weights from a ``.npz`` (``save_clip_weights``, either package),
    a ``.pt``/``.pth`` state dict (OpenAI ``clip`` layout, told by
    ``visual.conv1.weight``, or HF ``CLIPModel`` layout; a TorchScript
    archive through ``torch.jit.load``) or an HF checkpoint directory
    (safetensors or pytorch_model.bin), as ``aiic_tpu.models.init.
    load_clip_weights`` reads them; the tree on ``device``, floating leaves
    in ``dtype``."""
    if path.endswith(".npz"):
        with np.load(path) as blob:
            flat = {k: blob[k] for k in blob.files}
        return params_from_numpy(flat, device=device, dtype=dtype)
    if os.path.isdir(path):
        st = os.path.join(path, "model.safetensors")
        if os.path.exists(st):
            from safetensors.torch import load_file

            sd = load_file(st)
        else:
            sd = torch.load(os.path.join(path, "pytorch_model.bin"), map_location="cpu",
                            weights_only=True)
        return from_hf_clip_state_dict(sd, config, device=device, dtype=dtype)
    if _is_torchscript(path):
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    convert = from_openai_clip_state_dict if "visual.conv1.weight" in sd else from_hf_clip_state_dict
    return convert(sd, config, device=device, dtype=dtype)


def save_clip_weights(params: Params, path: str) -> None:
    np.savez(path, **flatten_params(params))
