"""Rows 9 and 6's plain versions at the tile edges of their bf16 tensor-core
kernels on the card, against the JAX package's kernels on the CPU.

On the card, bf16 row 9 (``fused_attention_qkv_bwd``) runs two tensor-core
passes over 64 query rows, then 64 key rows, a block, with the other
operand streamed in 64-row tiles; bf16 row 6 (``fused_attention`` /
``flash_attention``) at D=64 runs the tensor-core core of rows 7-8 on
separate q, k, v. So S one short of, at and one past a tile (63, 64, 65),
one row (1) and two tiles and a row (129) are where their edges lie. The
plain versions are what the card holds those kernels to; here they are held
to the JAX kernels, run as tests/test_ops.py runs them (Pallas in interpret
mode), at a small width (W=128, H=2, D=64: the kernels' head dim), in fp32
and bf16, without a mask and with the causal mask. The JAX side is compiled
with ``xla_allow_excess_precision`` off, so XLA rounds every bf16
intermediate where the kernel does. Inputs are made with numpy from a seed
and handed to both packages. Tolerances:

- fp32: ``rtol = atol = 1e-5`` (only the order of the fp32 sums differs);
- bf16 row 6: every row's cosine >= 0.9999 and >= 99% of elements within 2
  bf16 ULPs (an fp32 difference at a rounding boundary moves one bf16 value
  of q·c, p or the output by an ULP);
- bf16 row 9, per row of the cotangent (the text-block kernels' bar): every
  row's cosine >= 0.9999 and every element within 2 bf16 ULPs of its row's
  largest |value|. Its dq and dk sum terms of both signs, and at S=1 they
  are the rounding noise of ds = p (dp - p dp) with p = 1 in either
  package, which no per-element ULP share can hold.

A mask that removes every key of a row is held on the card only, kernel
against plain (tests/test_torch_cuda.py), for the reason the docstring of
tests/test_torch_attention_tiles.py gives.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiic_tpu.models.clip import causal_mask as jax_causal_mask
from aiic_tpu.ops import attention as jax_attention
from aiic_tpu_torch.models.clip import causal_mask
from aiic_tpu_torch.ops import attention
from test_torch_attention import _close

torch.set_num_threads(2)

EXACT_BF16 = {"xla_allow_excess_precision": False}
WIDTH, HEADS, DIM = 128, 2, 64
EDGES = (1, 63, 64, 65, 129)
DTYPES = ["float32", "bfloat16"]


def _both(a, dtype):
    t, j = torch.from_numpy(a), jnp.asarray(a)
    if dtype == "bfloat16":
        return t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return t, j


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_per_row(o, r):
    """Row cosine >= 0.9999 and every element within 2 bf16 ULPs of its
    row's largest |value|."""
    o, r = o.reshape(-1, o.shape[-1]), r.reshape(-1, r.shape[-1])
    assert np.isfinite(o).all()
    rmax = np.maximum(np.abs(r).max(axis=-1, keepdims=True), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(rmax)) - 7)
    assert (np.abs(o - r) <= 2 * ulp).all(), float((np.abs(o - r) / ulp).max())
    cos = (o * r).sum(-1) / (np.linalg.norm(o, axis=-1) * np.linalg.norm(r, axis=-1))
    assert cos.min() >= 0.9999, cos.min()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("seq", EDGES)
def test_attention_qkv_bwd_plain_matches_jax_kernel_at_tile_edges(seq, masked, dtype):
    rng = np.random.default_rng(80 + seq)
    (qt, qj), (gt, gj) = (_both(rng.standard_normal(shape).astype(np.float32), dtype)
                          for shape in ((2, seq, 3 * WIDTH), (2, seq, WIDTH)))
    mt = causal_mask(seq) if masked else None
    mj = jnp.asarray(jax_causal_mask(seq) if masked else np.zeros((seq, seq)), jnp.float32)
    run = jax.jit(functools.partial(jax_attention.fused_attention_qkv_bwd, heads=HEADS,
                                    interpret=True), compiler_options=EXACT_BF16)
    ref = _np(run(qj, mj, gj))
    before = attention.fused_attention_qkv_bwd.launches
    out = attention.fused_attention_qkv_bwd(qt, mt, gt, heads=HEADS)
    assert attention.fused_attention_qkv_bwd.launches == before  # the CPU takes the plain version
    assert out.dtype == qt.dtype and out.shape == qt.shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(out), ref, rtol=1e-5, atol=1e-5)
    else:
        _close_per_row(_np(out), ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("seq", EDGES)
def test_fused_attention_plain_matches_jax_kernel_at_tile_edges(seq, masked, dtype):
    rng = np.random.default_rng(90 + seq)
    shape = (2, seq, HEADS, DIM)
    (qt, qj), (kt, kj), (vt, vj) = (
        _both(rng.standard_normal(shape).astype(np.float32), dtype) for _ in range(3))
    mt, mj = (causal_mask(seq), jax_causal_mask(seq)) if masked else (None, None)
    run = jax.jit(functools.partial(jax_attention.fused_attention, interpret=True),
                  compiler_options=EXACT_BF16)
    ref = run(qj, kj, vj, mj)
    before = attention.fused_attention.launches
    out = attention.flash_attention(qt, kt, vt, mt)
    assert attention.fused_attention.launches == before
    assert out.dtype == qt.dtype and out.shape == shape
    _close(out, ref, dtype)
