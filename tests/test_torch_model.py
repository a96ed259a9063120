"""The port's CLIP towers against the JAX package on the same weights.

- fp32 unquantized towers against JAX ``attn_impl="xla"`` and ``"pallas"``
  (the packed-QKV core kernel in interpret mode): within 1e-5 (the same
  math; only summation orders differ).
- the bf16 int8 serving towers (patch-major uint8 wire, int8 embed) against
  JAX ``attn_impl="pallas"`` (its kernels in interpret mode): every row's
  cosine >= 0.9999, because bf16 rounding flips at a few boundaries move an
  int8 quantization step somewhere in the tower. The JAX towers compile
  with ``xla_allow_excess_precision`` off, so that XLA rounds every bf16
  intermediate as the port does (see test_torch_engine.py).
- the bf16 unquantized towers (the worker's default) against JAX
  ``attn_impl="pallas"`` and ``"pallas_mlp"``: every row's cosine >= 0.9999,
  for the same reason (a bf16 rounding flip moves one value by an ULP).
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
from aiic_tpu_torch.data.preprocess import CLIP_MEAN, CLIP_STD
from aiic_tpu_torch.models import clip
from aiic_tpu_torch.models.config import TINY_TEST
from aiic_tpu_torch.models.init import params_from_numpy
from aiic_tpu_torch.ops import quant

torch.set_num_threads(2)


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


def _jax_tower(fn, params, x, attn_impl="pallas"):
    f = jax.jit(functools.partial(fn, config=JAX_TINY, dtype=jnp.bfloat16, attn_impl=attn_impl),
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
    out = clip.encode_image(tp, tx, TINY_TEST, dtype=torch.float32, attn_impl="xla").numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_encode_text_fp32_matches_jax_xla(weights):
    jp, tp = weights
    tok = _tokens()
    ref = np.asarray(jax_clip.encode_text(jp, jnp.asarray(tok), JAX_TINY, dtype=jnp.float32,
                                          attn_impl="xla"))
    out = clip.encode_text(tp, torch.from_numpy(tok), TINY_TEST, dtype=torch.float32,
                           attn_impl="xla").numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tower", ["image_hwc", "image_patch", "text"])
def test_fp32_towers_match_jax_pallas(weights, tower):
    """The batch CLI's default: fp32 towers on the packed-QKV core kernel."""
    jp, tp = weights
    if tower == "text":
        tok = _tokens(seed=11)
        ref = jax_clip.encode_text(jp, jnp.asarray(tok), JAX_TINY, dtype=jnp.float32,
                                   attn_impl="pallas")
        out = clip.encode_text(tp, torch.from_numpy(tok), TINY_TEST, dtype=torch.float32)
    else:
        px = _images(seed=12)
        pix = ((px.astype(np.float32) / 255.0 - 0.45) / 0.27 if tower == "image_hwc"
               else to_patch_major(px, TINY_TEST.patch_size))
        ref = jax_clip.encode_image(jp, jnp.asarray(pix), JAX_TINY, dtype=jnp.float32,
                                    attn_impl="pallas")
        out = clip.encode_image(tp, torch.from_numpy(pix), TINY_TEST, dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attn_impl", ["pallas", "pallas_mlp"])
@pytest.mark.parametrize("tower", ["image", "text"])
def test_bf16_unquantized_towers_match_jax(weights, tower, attn_impl):
    """The worker's default: bf16 without int8 weights, on the bf16
    attention half-block (and under pallas_mlp the fused LN+MLP) kernels."""
    jp, tp = weights
    if tower == "text":
        tok = _tokens(seed=13)
        ref = _jax_tower(jax_clip.encode_text, jp, tok, attn_impl)
        out = clip.encode_text(tp, torch.from_numpy(tok), TINY_TEST, dtype=torch.bfloat16,
                               attn_impl=attn_impl)
    else:
        px = _images(4, seed=14)  # uint8 HWC, normalized as the HWC wire does
        norm = (px.astype(np.float32) - 255.0 * CLIP_MEAN) / (255.0 * CLIP_STD)
        ref = _jax_tower(jax_clip.encode_image, jp, norm.astype(jnp.bfloat16), attn_impl)
        out = clip.encode_image(tp, torch.from_numpy(norm).to(torch.bfloat16), TINY_TEST,
                                dtype=torch.bfloat16, attn_impl=attn_impl)
    assert out.dtype == torch.float32
    assert _row_cos(out.numpy(), ref).min() >= 0.9999


BRANCHES = [  # (dtype, quantized tree, attn_impl) -> (attention half, MLP half)
    ("bfloat16", True, "pallas", ("int8_ln_qkv_attention", "int8_ln_mlp")),
    ("bfloat16", True, "pallas_mlp", ("int8_ln_qkv_attention", "int8_ln_mlp")),
    ("bfloat16", True, "xla", ("xla", "plain")),
    ("bfloat16", False, "pallas", ("fused_ln_qkv_attention", "plain")),
    ("bfloat16", False, "pallas_mlp", ("fused_ln_qkv_attention", "fused_ln_mlp")),
    ("bfloat16", False, "xla", ("xla", "plain")),
    ("float32", False, "pallas", ("fused_attention_qkv", "plain")),
    ("float32", True, "pallas_mlp", ("fused_attention_qkv", "plain")),
    ("float32", False, "xla", ("xla", "plain")),
]


@pytest.mark.parametrize("dtype,quantized,attn_impl,want", BRANCHES,
                         ids=[f"{d}-{'int8' if q else 'fp'}-{a}" for d, q, a, _ in BRANCHES])
def test_block_takes_the_jax_branch(quantized, weights, monkeypatch, dtype, attn_impl, want):
    """``block`` picks each half's path in ``aiic_tpu.models.clip.block``'s
    order; recorded by wrapping each kernel wrapper and the xla core."""
    from aiic_tpu_torch.ops import attention, mlp

    _, tp = weights
    tree = quant.quantize_model(tp) if quantized else tp
    calls = []
    for mod, name in ((quant, "int8_ln_qkv_attention"), (quant, "int8_ln_mlp"),
                      (attention, "fused_ln_qkv_attention"), (attention, "fused_attention_qkv"),
                      (mlp, "fused_ln_mlp")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    xla = clip.attention_qkv_ref
    monkeypatch.setattr(clip, "attention_qkv_ref", lambda *a: calls.append("xla") or xla(*a))
    x = torch.from_numpy(np.random.default_rng(15).standard_normal((2, 5, 64)).astype(np.float32))
    out = clip.block(x.to(getattr(torch, dtype)), clip._layer(tree["visual"]["blocks"], 0), 4,
                     None, "quick_gelu", attn_impl)
    assert out.dtype == getattr(torch, dtype) and torch.isfinite(out.float()).all()
    assert tuple(calls) + ("plain",) * (2 - len(calls)) == want
    with pytest.raises(ValueError, match="attn_impl"):
        clip.block(x, clip._layer(tree["visual"]["blocks"], 0), 4, None, "quick_gelu", "flash")
    # "auto" is the JAX trainer's resolution: the reference composition on
    # the CPU ("pallas_vjp" on a CUDA tensor)
    calls.clear()
    clip.block(x, clip._layer(tree["visual"]["blocks"], 0), 4, None, "quick_gelu", "auto")
    assert calls == ["xla"]


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
