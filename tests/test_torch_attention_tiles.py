"""Rows 7 and 8's plain versions at the tile edges of the card's tensor-core
core, against the JAX package's kernels on the CPU.

The bf16 core of rows 7 (``fused_attention_qkv``) and 8
(``fused_attention_qkv_headgroups``) on the card works in 64-row query
blocks and 64-key tiles, so S one short of, at and one past a tile (63, 64,
65), one row (1) and two tiles and a row (129) are where its edges lie. The
plain versions are what the card holds that core to; here they are held to
the JAX kernels, run as tests/test_ops.py runs them (Pallas in interpret
mode), at a small width (W=128, H=2, D=64: the core's head dim), in fp32
and bf16, without a mask and with the causal mask. The JAX side is
compiled with ``xla_allow_excess_precision`` off, so XLA rounds every bf16
intermediate where the kernel does. Inputs are made with numpy from a seed
and handed to both packages. Tolerances:

- fp32: ``rtol = atol = 1e-5`` (only the order of the fp32 score, row and
  p·V sums differs);
- bf16: every row's cosine >= 0.9999 and >= 99% of elements within 2 bf16
  ULPs (an fp32 difference at a rounding boundary moves one bf16 value of
  q·c, p or the output by an ULP).

A mask that removes every key of a row is held on the card only, kernel
against plain (tests/test_torch_cuda.py): the JAX kernels' 1e-38
denominator guard is an fp32 subnormal, which XLA's CPU flushes to zero, so
such a row is 0/0 in the JAX package on the CPU and zero in the port.
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
WIDTH, HEADS = 128, 2
EDGES = (1, 63, 64, 65, 129)
DTYPES = ["float32", "bfloat16"]


def _inputs(seq, masked, dtype, seed):
    """(B=2, S, 3W) qkv and the mask (None or causal) for both packages."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, seq, 3 * WIDTH)).astype(np.float32)
    qt, qj = torch.from_numpy(a), jnp.asarray(a)
    if dtype == "bfloat16":
        qt, qj = qt.to(torch.bfloat16), qj.astype(jnp.bfloat16)
    if not masked:
        return qt, qj, None, None
    return qt, qj, causal_mask(seq), jax_causal_mask(seq)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("seq", EDGES)
def test_attention_qkv_plain_matches_jax_kernel_at_tile_edges(seq, masked, dtype):
    qt, qj, mt, mj = _inputs(seq, masked, dtype, seed=40 + seq)
    run = jax.jit(functools.partial(jax_attention.fused_attention_qkv, heads=HEADS,
                                    interpret=True), compiler_options=EXACT_BF16)
    ref = run(qj, mj)
    before = attention.fused_attention_qkv.launches
    out = attention.fused_attention_qkv(qt, mt, heads=HEADS)
    assert attention.fused_attention_qkv.launches == before  # the CPU takes the plain version
    assert out.dtype == qt.dtype and out.shape == (2, seq, WIDTH)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("head_group", [1, 2])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("seq", EDGES)
def test_headgroups_plain_matches_jax_kernel_at_tile_edges(seq, masked, head_group, dtype):
    """Row 8 on a head-major projection (the same random columns read as
    [q_h | k_h | v_h] per head) at hg = 1 and 2 (= H)."""
    qt, qj, mt, mj = _inputs(seq, masked, dtype, seed=60 + seq)
    run = jax.jit(functools.partial(jax_attention.fused_attention_qkv_headgroups, heads=HEADS,
                                    head_group=head_group, interpret=True),
                  compiler_options=EXACT_BF16)
    ref = run(qj, mj)
    before = attention.fused_attention_qkv_headgroups.launches
    out = attention.fused_attention_qkv_headgroups(qt, mt, heads=HEADS, head_group=head_group)
    assert attention.fused_attention_qkv_headgroups.launches == before
    assert out.dtype == qt.dtype and out.shape == (2, seq, WIDTH)
    _close(out, ref, dtype)
