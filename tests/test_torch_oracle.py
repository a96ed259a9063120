"""The port's towers against a ``transformers.CLIPModel`` oracle, and the
parity-report twin.

A seeded random ``CLIPModel`` at TINY_TEST's geometry (image 32, patch 8,
widths 64 / 32, 2 layers, 4 heads, vocabulary 512, context 16, quick-gelu)
goes into the port through ``from_hf_clip_state_dict``:

- the fp32 towers (the plain CPU path) agree with the oracle's projected
  features within rtol = atol = 2e-4 (tests/test_parity_torch.py's bar), and
  their 100·img@text.T logits reach a cosine of 0.999 (BASELINE.md's bar);
- the serving configuration (bf16, the port's ``quantize_model``, the
  patch-major uint8 wire) reaches a logit cosine of 0.999 against the fp32
  oracle over the 40 detector prompts. At this width one int8 step moves an
  interior mass by a few hundredths: an image whose oracle mass is 0.467
  gets 0.515 in the JAX package's serving configuration and in the port's
  alike, so here the verdicts are held equal to the JAX package's serving
  configuration on the same weights (its kernels in interpret mode, every
  bf16 rounding kept), and the oracle's verdicts at ViT-B/16 by the twin.

``tools/torch_parity_report.py --device cpu --limit 2`` on generated
``dataset_images/`` at ViT-B/16 (its own seeded oracle, the geometry of
tests/test_parity_torch.py's serving-config test) prints
``passes_0999_bar: true`` and a verdict agreement of 1.0, in fp32 and in the
serving configuration.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from aiic_tpu_torch.data.preprocess import CLIP_MEAN, CLIP_STD
from aiic_tpu_torch.data.tokenizer import tokenize_for_model
from aiic_tpu_torch.engine.detector import DETECTOR_CATEGORIES, INTERIOR_COUNT
from aiic_tpu_torch.models import TINY_TEST, encode_image, encode_text, normalize_features
from aiic_tpu_torch.models.init import from_hf_clip_state_dict, tree_map
from aiic_tpu_torch.ops import quant
from aiic_tpu_torch.ops.preprocess import to_patch_major

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch_parity_report  # noqa: E402

TOL = 2e-4


@pytest.fixture(scope="module")
def oracle():
    from transformers import CLIPConfig, CLIPModel

    c = TINY_TEST
    tower = lambda t: dict(hidden_size=t.width, intermediate_size=t.mlp_dim,  # noqa: E731
                           num_hidden_layers=t.layers, num_attention_heads=t.heads,
                           hidden_act="quick_gelu")
    cfg = CLIPConfig(text_config=dict(tower(c.text), max_position_embeddings=c.context_length,
                                      vocab_size=c.vocab_size, eos_token_id=c.vocab_size - 1),
                     vision_config=dict(tower(c.vision), image_size=c.image_size,
                                        patch_size=c.patch_size),
                     projection_dim=c.embed_dim)
    torch.manual_seed(0)
    model = CLIPModel(cfg).eval()
    return model, from_hf_clip_state_dict(model.state_dict(), c)


def _images(n, seed):
    s = TINY_TEST.image_size
    return np.random.default_rng(seed).integers(0, 256, (n, s, s, 3), dtype=np.uint8)


def _normalized(u8):
    return (((u8.astype(np.float32) / 255.0) - CLIP_MEAN) / CLIP_STD).astype(np.float32)


def _random_tokens(n, seed):
    """SOT, random ids, EOT (the highest id), zero padding."""
    c = TINY_TEST
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, c.vocab_size - 2, (n, c.context_length)).astype(np.int64)
    tok[:, 0] = c.vocab_size - 2
    for i, p in enumerate(rng.integers(3, c.context_length - 1, n)):
        tok[i, p] = c.vocab_size - 1
        tok[i, p + 1:] = 0
    return tok


def _cosine(a, b):
    a, b = a.ravel(), b.ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_image_tower_matches_clip_model(oracle):
    model, params = oracle
    px = _normalized(_images(3, seed=1))
    with torch.no_grad():
        pooled = model.vision_model(pixel_values=torch.from_numpy(px).permute(0, 3, 1, 2))
        ref = model.visual_projection(pooled.pooler_output).numpy()
    ours = encode_image(params, torch.from_numpy(px), TINY_TEST).numpy()
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


def test_text_tower_matches_clip_model(oracle):
    model, params = oracle
    tok = _random_tokens(4, seed=2)
    with torch.no_grad():
        ref = model.text_projection(
            model.text_model(input_ids=torch.from_numpy(tok)).pooler_output).numpy()
    ours = encode_text(params, torch.from_numpy(tok), TINY_TEST).numpy()
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


def test_fp32_logit_agreement_at_baseline_bar(oracle):
    model, params = oracle
    px = _normalized(_images(4, seed=3))
    tok = _random_tokens(8, seed=4)
    rimg, rtxt = torch_parity_report.oracle_features(model, px, tok)
    ref = 100.0 * rimg @ rtxt.T
    ours = 100.0 * (normalize_features(encode_image(params, torch.from_numpy(px), TINY_TEST))
                    @ normalize_features(encode_text(params, torch.from_numpy(tok), TINY_TEST)).T)
    assert _cosine(ours.numpy(), ref) >= 0.999
    np.testing.assert_allclose(ours.numpy(), ref, atol=5e-3)


def test_serving_config_matches_clip_model(oracle):
    """bf16 + int8 MLP and attention-projection weights + the patch-major
    uint8 wire, all errors compounded, against the fp32 oracle over the 40
    detector prompts: logit cosine >= 0.999; the verdicts those of the JAX
    package's serving configuration on the same weights."""
    import jax
    import jax.numpy as jnp

    from aiic_tpu.models import clip as jax_clip
    from aiic_tpu.models.config import TINY_TEST as JAX_TINY
    from aiic_tpu.models.init import from_hf_clip_state_dict as jax_from_hf
    from aiic_tpu.ops.quant import quantize_model as jax_quantize

    model, params = oracle
    u8 = _images(6, seed=5)
    wire = to_patch_major(u8, TINY_TEST.patch_size)
    tok = tokenize_for_model(DETECTOR_CATEGORIES, TINY_TEST).astype(np.int64)
    rimg, rtxt = torch_parity_report.oracle_features(model, _normalized(u8), tok)
    ref = 100.0 * rimg @ rtxt.T

    qparams = quant.quantize_model(tree_map(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t, params))
    img = normalize_features(encode_image(qparams, torch.from_numpy(wire), TINY_TEST,
                                          dtype=torch.bfloat16, attn_impl="pallas"))
    txt = normalize_features(encode_text(qparams, torch.from_numpy(tok), TINY_TEST,
                                         dtype=torch.bfloat16, attn_impl="pallas"))
    ours = (100.0 * img @ txt.T).numpy()
    assert _cosine(ours, ref) >= 0.999, _cosine(ours, ref)

    jq = jax_quantize(jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                   jax_from_hf(model.state_dict(), JAX_TINY)))
    exact = {"xla_allow_excess_precision": False}
    towers = [jax.jit(functools.partial(fn, config=JAX_TINY, dtype=jnp.bfloat16,
                                        attn_impl="pallas"), compiler_options=exact)
              for fn in (jax_clip.encode_image, jax_clip.encode_text)]
    jimg = jax_clip.normalize_features(towers[0](jq, jnp.asarray(wire)))
    jtxt = jax_clip.normalize_features(towers[1](jq, jnp.asarray(tok.astype(np.int32))))
    want = np.asarray(100.0 * jimg @ jtxt.T)
    rows = (ours * want).sum(-1) / (np.linalg.norm(ours, axis=-1) * np.linalg.norm(want, axis=-1))
    assert rows.min() >= 0.9999, rows
    np.testing.assert_array_equal(torch_parity_report.verdict(ours, INTERIOR_COUNT),
                                  torch_parity_report.verdict(want, INTERIOR_COUNT))


@pytest.mark.parametrize("flags", [[], ["--dtype", "bfloat16", "--quantize", "--wire", "patch",
                                          "--attn-impl", "pallas"]], ids=["fp32", "serving"])
def test_parity_report_twin_passes_the_bar(tmp_path, flags):
    from PIL import Image

    os.makedirs(tmp_path / "dataset_images")
    rng = np.random.default_rng(7)
    for i, (h, w) in enumerate([(240, 300), (260, 230), (230, 230)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            tmp_path / "dataset_images" / f"im{i}.jpg", quality=90)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "USE_TF": "0"}
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_parity_report.py"),
         "--reference-root", str(tmp_path), "--device", "cpu", "--limit", "2"] + flags,
        capture_output=True, text=True, timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["images"] == 2
    assert out["passes_0999_bar"] is True and out["logit_cosine_agreement"] >= 0.999
    assert out["detector_verdict_agreement"] == 1.0
