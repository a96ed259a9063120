"""The port's CLIP towers against the JAX package on the same weights.

- fp32 unquantized towers against JAX ``attn_impl="xla"``: within 1e-5
  (the same math; only summation orders differ).
- the bf16 int8 serving towers (patch-major uint8 wire, int8 embed) against
  JAX ``attn_impl="pallas"`` (its kernels in interpret mode): every row's
  cosine >= 0.9999, because bf16 rounding flips at a few boundaries move an
  int8 quantization step somewhere in the tower. The JAX towers compile
  with ``xla_allow_excess_precision`` off, so that XLA rounds every bf16
  intermediate as the port does (see test_torch_engine.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiic_tpu.models import clip as jax_clip
from aiic_tpu.models.config import TINY_TEST as JAX_TINY
from aiic_tpu.models.init import flatten_params, init_clip_params
from aiic_tpu.ops import quant as jax_quant
from aiic_tpu.ops.preprocess import to_patch_major
from aiic_tpu_torch.models import clip
from aiic_tpu_torch.models.config import TINY_TEST
from aiic_tpu_torch.models.init import params_from_numpy
from aiic_tpu_torch.ops import quant


@pytest.fixture(scope="module")
def weights():
    jp = init_clip_params(jax.random.PRNGKey(0), JAX_TINY)
    return jp, params_from_numpy(flatten_params(jp))


@pytest.fixture(scope="module")
def quantized(weights):
    jp, _ = weights
    jq = jax_quant.quantize_model(jp)
    return jq, quant.quantize_model(params_from_numpy(flatten_params(jp)))


def _images(n=3, seed=1):
    s = TINY_TEST.image_size
    return np.random.default_rng(seed).integers(0, 256, (n, s, s, 3), dtype=np.uint8)


def _tokens(seed=2):
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, TINY_TEST.vocab_size - 2, (3, TINY_TEST.context_length)).astype(np.int32)
    for i, n in enumerate((5, 9, TINY_TEST.context_length)):
        tok[i, n - 1] = TINY_TEST.vocab_size - 1  # EOT
        tok[i, n:] = 0
    return tok


EXACT_BF16 = {"xla_allow_excess_precision": False}


def _jax_tower(fn, params, x):
    f = jax.jit(functools.partial(fn, config=JAX_TINY, dtype=jnp.bfloat16, attn_impl="pallas"),
                compiler_options=EXACT_BF16)
    return np.asarray(f(params, jnp.asarray(x)), np.float32)


def _row_cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("wire", ["hwc_float", "patch_u8"])
def test_encode_image_fp32_matches_jax_xla(weights, wire):
    jp, tp = weights
    px = _images()
    if wire == "hwc_float":
        pix = (px.astype(np.float32) / 255.0 - 0.45) / 0.27
        jx, tx = jnp.asarray(pix), torch.from_numpy(pix)
    else:
        pm = to_patch_major(px, TINY_TEST.patch_size)
        jx, tx = jnp.asarray(pm), torch.from_numpy(pm)
    ref = np.asarray(jax_clip.encode_image(jp, jx, JAX_TINY, dtype=jnp.float32, attn_impl="xla"))
    out = clip.encode_image(tp, tx, TINY_TEST, dtype=torch.float32).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_encode_text_fp32_matches_jax_xla(weights):
    jp, tp = weights
    tok = _tokens()
    ref = np.asarray(jax_clip.encode_text(jp, jnp.asarray(tok), JAX_TINY, dtype=jnp.float32,
                                          attn_impl="xla"))
    out = clip.encode_text(tp, torch.from_numpy(tok), TINY_TEST, dtype=torch.float32).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_encode_image_int8_serving_matches_jax_pallas(quantized):
    jq, tq = quantized
    pm = to_patch_major(_images(4, seed=3), TINY_TEST.patch_size)
    ref = _jax_tower(jax_clip.encode_image, jq, pm)
    out = clip.encode_image(tq, torch.from_numpy(pm), TINY_TEST, dtype=torch.bfloat16)
    assert out.dtype == torch.float32 and out.shape == (4, TINY_TEST.embed_dim)
    assert _row_cos(out.numpy(), ref).min() >= 0.9999


def test_encode_text_int8_serving_matches_jax_pallas(quantized):
    jq, tq = quantized
    tok = _tokens(seed=4)
    ref = _jax_tower(jax_clip.encode_text, jq, tok)
    out = clip.encode_text(tq, torch.from_numpy(tok), TINY_TEST, dtype=torch.bfloat16).numpy()
    assert _row_cos(out, ref).min() >= 0.9999


def test_block_cls_matches_jax(weights):
    jp, tp = weights
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, TINY_TEST.vision_seq_len, TINY_TEST.vision.width)).astype(np.float32)
    last = jax.tree.map(lambda a: a[-1], jp["visual"]["blocks"])
    ref = np.asarray(jax_clip.block_cls(jnp.asarray(x), last, TINY_TEST.vision.heads, "quick_gelu"))
    out = clip.block_cls(torch.from_numpy(x), clip._layer(tp["visual"]["blocks"], -1),
                         TINY_TEST.vision.heads, "quick_gelu").numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_primitives_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(16)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(16)).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    np.testing.assert_allclose(clip.layer_norm(torch.from_numpy(x), tp).numpy(),
                               np.asarray(jax_clip.layer_norm(jnp.asarray(x), p)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(clip.quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_clip.quick_gelu(jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(clip.causal_mask(7).numpy(), np.asarray(jax_clip.causal_mask(7)))
    img = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(clip.patchify(torch.from_numpy(img), 8).numpy(),
                                  np.asarray(jax_clip.patchify(jnp.asarray(img), 8)))
    np.testing.assert_allclose(clip.normalize_features(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_clip.normalize_features(jnp.asarray(x))), rtol=1e-6)
