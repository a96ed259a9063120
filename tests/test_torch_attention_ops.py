"""The attention-core ops that no engine reaches (rows 6 and 9), the
tensor-core probe's plain versions (row 17) and ``"auto"``'s resolution,
against the JAX package on the CPU.

The JAX kernels run as tests/test_ops.py runs them: Pallas in interpret
mode; the bf16 side is compiled with ``xla_allow_excess_precision`` off so
that XLA rounds every bf16 intermediate. Inputs are made with numpy from a
seed and handed to both packages. Tolerances:

- ``fused_attention`` (row 6) in fp32: ``rtol = atol = 1e-5``, tighter than
  tests/test_ops.py's 2e-5 against the XLA softmax, because the function is
  the same (only the order of the fp32 score, row and p·V sums differs);
- ``fused_attention_qkv_bwd`` (row 9) in fp32: within 1e-5 of the largest
  |entry| (its cotangents sum S products of fp32 terms of both signs);
  against the autograd VJP of the stable composition, JAX's own bar
  (``rtol = atol = 2e-4``): the two softmaxes differ only in rounding here;
- bf16: every row's cosine >= 0.9999 and >= 99% of elements within 2 bf16
  ULPs (an fp32 difference at a rounding boundary moves one bf16 value of
  q·c, p, ds or the output by an ULP);
- the probe's plain versions against a numpy formula: int8 and the
  quantized body exactly (integer products, the same fp32 operations), bf16
  within one bf16 rounding of the float64 sum;
- the whole text block's core backward step is row 9's plain version bit
  for bit (bf16, and fp32 with ``out_dtype``), the premise of rows 12 and
  14 running row 9's tensor-core passes on the card.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from aiic_tpu.models.clip import causal_mask as jax_causal_mask
from aiic_tpu.ops import attention as jax_attention
from aiic_tpu_torch.models import clip
from aiic_tpu_torch.models.clip import causal_mask
from aiic_tpu_torch.ops import attention, block_grad
from aiic_tpu_torch.probes import mxu_probe

torch.set_num_threads(2)

EXACT_BF16 = {"xla_allow_excess_precision": False}
# tests/test_ops.py:22-26: ViT tower, text tower (causal), tiny with heavy padding
ROW6_GEOMETRIES = [(197, 12, 64, False), (77, 8, 64, True), (16, 4, 8, True)]
# tests/test_ops.py:531-549's text geometry, the tiny one, the ViT tower
ROW9_GEOMETRIES = [(77, 8, 64, True), (16, 4, 8, True), (197, 12, 64, False)]
DTYPES = ["float32", "bfloat16"]


def _both(a, dtype):
    """The same numpy array as a torch tensor and a jax array of ``dtype``."""
    t, j = torch.from_numpy(np.array(a)), jnp.asarray(a)
    if dtype == "bfloat16":
        return t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return t, j


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_close(o, r):
    o, r = o.reshape(-1, o.shape[-1]), r.reshape(-1, r.shape[-1])
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126))) - 7)
    assert (np.abs(o - r) <= 2 * ulp).mean() >= 0.99
    cos = (o * r).sum(-1) / (np.linalg.norm(o, axis=-1) * np.linalg.norm(r, axis=-1))
    assert cos.min() >= 0.9999, cos.min()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seq,heads,dim,use_mask", ROW6_GEOMETRIES,
                         ids=["vit", "text_causal", "tiny_causal"])
def test_fused_attention_plain_matches_jax_kernel(seq, heads, dim, use_mask, dtype):
    rng = np.random.default_rng(0)
    shape = (2, seq, heads, dim)
    (qt, qj), (kt, kj), (vt, vj) = (
        _both(rng.standard_normal(shape).astype(np.float32), dtype) for _ in range(3))
    mt, mj = (causal_mask(seq), jax_causal_mask(seq)) if use_mask else (None, None)
    run = jax.jit(functools.partial(jax_attention.fused_attention, interpret=True),
                  compiler_options=EXACT_BF16)
    ref = _np(run(qj, kj, vj, mj))
    before = attention.fused_attention.launches
    out = attention.flash_attention(qt, kt, vt, mt)
    assert out.dtype == qt.dtype and out.shape == shape
    assert attention.fused_attention.launches == before  # the CPU takes the plain version
    torch.testing.assert_close(attention.fused_attention(qt, kt, vt, mt, block_pairs=3), out,
                               rtol=0, atol=0)
    if dtype == "float32":
        np.testing.assert_allclose(_np(out), ref, rtol=1e-5, atol=1e-5)
    else:
        _bf16_close(_np(out), ref)


def _row9_inputs(seq, heads, dim, use_mask, dtype, seed=5):
    rng = np.random.default_rng(seed)
    width = heads * dim
    qkv = _both(rng.standard_normal((2, seq, 3 * width)).astype(np.float32), dtype)
    g = _both(rng.standard_normal((2, seq, width)).astype(np.float32), dtype)
    mt = causal_mask(seq) if use_mask else None
    mj = jnp.asarray(jax_causal_mask(seq) if use_mask else np.zeros((seq, seq)), jnp.float32)
    return qkv, g, (mt, mj)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seq,heads,dim,use_mask", ROW9_GEOMETRIES,
                         ids=["text_causal", "tiny_causal", "vit"])
def test_fused_attention_qkv_bwd_plain_matches_jax_kernel(seq, heads, dim, use_mask, dtype):
    (qt, qj), (gt, gj), (mt, mj) = _row9_inputs(seq, heads, dim, use_mask, dtype)
    run = jax.jit(functools.partial(jax_attention.fused_attention_qkv_bwd, heads=heads,
                                    interpret=True), compiler_options=EXACT_BF16)
    ref = _np(run(qj, mj, gj))
    before = attention.fused_attention_qkv_bwd.launches
    out = attention.fused_attention_qkv_bwd(qt, mt, gt, heads=heads)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    assert attention.fused_attention_qkv_bwd.launches == before
    if dtype == "float32":
        assert np.abs(_np(out) - ref).max() <= 1e-5 * np.abs(ref).max()
    else:
        _bf16_close(_np(out), ref)


@pytest.mark.parametrize("seq,heads,dim,use_mask", ROW9_GEOMETRIES,
                         ids=["text_causal", "tiny_causal", "vit"])
def test_fused_attention_qkv_bwd_plain_matches_autograd_of_the_composition(seq, heads, dim,
                                                                           use_mask):
    """Row 9's plain version against the VJP that ``pallas_vjp`` runs (autograd
    through the stable-softmax composition), at tests/test_ops.py's bar; the
    cotangent g in another dtype is cast to qkv's, as ``_fa_vjp_bwd`` does."""
    (qt, _), (gt, _), (mt, _) = _row9_inputs(seq, heads, dim, use_mask, "float32", seed=6)
    t = qt.clone().requires_grad_()
    (want,) = torch.autograd.grad(attention.attention_qkv_ref(t, mt, heads), t, gt)
    got = attention.fused_attention_qkv_bwd(qt, mt, gt.double(), heads=heads)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("seq,heads,dim,use_mask", ROW9_GEOMETRIES,
                         ids=["text_causal", "tiny_causal", "vit"])
def test_text_block_core_step_is_row9(seq, heads, dim, use_mask):
    """The premise of rows 12 and 14 running their core backward on row 9's
    passes: the whole text block's core step (``block_grad._core_bwd`` on
    ``_core_probs``, the mask as the block takes it, zeros for none) is row
    9's plain version bit for bit in bf16: rounded once, as row 12 stores
    dqkv, and unrounded with ``out_dtype=torch.float32``, as row 14 stores it
    for its row quantizer. Both hold the bf16 bar above against JAX's
    ``fused_attention_qkv_bwd`` (interpret mode, excess precision off)."""
    (qt, qj), (gt, gj), (mt, mj) = _row9_inputs(seq, heads, dim, use_mask, "bfloat16", seed=7)
    probs = block_grad._core_probs(qt, block_grad._mask_or_zeros(mt, qt), heads)
    step = block_grad._core_bwd(qt, probs, gt, heads)
    unrounded = attention.fused_attention_qkv_bwd_ref(qt, mt, gt, heads=heads,
                                                      out_dtype=torch.float32)
    rounded = attention.fused_attention_qkv_bwd_ref(qt, mt, gt, heads=heads)
    assert step.dtype == unrounded.dtype == torch.float32 and rounded.dtype == torch.bfloat16
    assert torch.equal(step, unrounded)
    assert torch.equal(step.to(torch.bfloat16), rounded)
    run = jax.jit(functools.partial(jax_attention.fused_attention_qkv_bwd, heads=heads,
                                    interpret=True), compiler_options=EXACT_BF16)
    ref = _np(run(qj, mj, gj))
    _bf16_close(_np(rounded), ref)
    _bf16_close(_np(unrounded), ref)


def test_resolve_attn_impl_auto_as_jax():
    """``"auto"`` is JAX's resolution (``aiic_tpu.ops.attention.resolve_attn_impl``):
    the serving kernels on the accelerator, the reference composition
    elsewhere; every other value passes through."""
    assert clip.resolve_attn_impl("auto", "cuda") == "pallas"
    assert clip.resolve_attn_impl("auto", "cpu") == "xla"
    assert jax_attention.resolve_attn_impl("auto") == "xla"  # JAX on the CPU, as here
    for impl in clip.ATTN_IMPLS[1:]:
        assert clip.resolve_attn_impl(impl, "cuda") == clip.resolve_attn_impl(impl, "cpu") == impl


def _probe_inputs(rows=8, depth=32, cols=16, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, depth)).astype(ml_dtypes.bfloat16)
    x[1] = 0  # an all-zero row: the 1e-6 scale floor at i = 0
    x_i8 = rng.integers(-127, 127, (rows, depth)).astype(np.int8)
    w = (rng.standard_normal((depth, cols)) * 0.05).astype(ml_dtypes.bfloat16)
    w_i8 = rng.integers(-127, 127, (depth, cols)).astype(np.int8)
    return x, x_i8, w, w_i8


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def test_mxu_probe_plain_versions_match_numpy():
    inner = 3
    before = [f.launches for f in (mxu_probe.mxu_bf16, mxu_probe.mxu_i8, mxu_probe.mxu_i8_quant)]
    x, x_i8, w, w_i8 = _probe_inputs()

    acc = sum((x + ml_dtypes.bfloat16(i)).astype(np.float64) @ w.astype(np.float64)
              for i in range(inner))
    out = mxu_probe.mxu_bf16(_t(x), _t(w), inner)
    assert out.dtype == torch.bfloat16 and out.shape == acc.shape
    assert np.all(np.abs(out.float().numpy() - acc) <= 2.0 ** -8 * np.abs(acc) + 1e-6)

    acc = sum((x_i8 ^ np.int8(i)).astype(np.int64) @ w_i8.astype(np.int64) for i in range(inner))
    out = mxu_probe.mxu_i8(_t(x_i8), _t(w_i8), inner)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), acc)

    acc = np.zeros(acc.shape, np.float32)
    for i in range(inner):
        xf = x.astype(np.float32) + np.float32(i)
        scale = np.maximum(np.abs(xf).max(-1, keepdims=True), np.float32(1e-6)) / np.float32(127)
        q = np.clip(np.rint(xf / scale), -127, 127).astype(np.int64)
        acc = acc + (q @ w_i8.astype(np.int64)).astype(np.float32) * scale
    out = mxu_probe.mxu_i8_quant(_t(x), _t(w_i8), inner)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), acc.astype(ml_dtypes.bfloat16).astype(np.float32))
    assert [f.launches for f in (mxu_probe.mxu_bf16, mxu_probe.mxu_i8,
                                 mxu_probe.mxu_i8_quant)] == before  # the CPU takes the plain versions
