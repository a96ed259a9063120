"""The algebra of the Hopper forms of rows 9 (fp32) and 17 that differs from
their plain versions, against the JAX package on the CPU, and the forms'
argument checks.

- Row 9's fp32 register-tiled form (``csrc/attn_core_bwd_f32.cuh``) sums
  u = rowsum(e∘dp) beside l = rowsum(e) and takes delta = u·inv, where the
  plain version takes rowsum(p∘dp) after l.
  ``fused_attention_qkv_bwd_ul_ref`` renders that way in plain PyTorch; it
  is held to the JAX kernel ``_attention_qkv_bwd_kernel``, run as
  tests/test_torch_attention_bwd_tiles.py runs it (Pallas in interpret
  mode), at the tile edges of the form (S = 1, 13, 63, 64, 65, 129, 197 and
  77 causal; W=128, H=2), in fp32 at ``rtol = atol = 1e-5``: only the order
  and place of fp32 roundings differ.
- Row 17's i8_quant wgmma form takes each row's scale for product i from
  the row's max and min alone (``quant_scales_from_extremes``: fl(x + i) is
  monotone in x); it is held bit for bit to the scales of
  ``mxu_i8_quant_ref`` (``quant_scale``) on the probe's own inputs, one row
  block, for every i < 64.
- The forms' argument checks raise ValueError before the kernel library is
  loaded (here it cannot be: there is no nvcc), as the checks of the older
  forms do. That covers fp32 rows 6 and 7's forms: the register-tiled core
  (the route, any S) and the scalar core it replaced (``form="scalar"``,
  fp32 at D=64 only, K and V of a head within shared memory).
- Routing, with the card route forced: fp32 row 6 at D=64 reaches the
  register-tiled form at any S (S=257, 577), and the copied JAX planner
  still routes fp32 row 7: fp32 ``fused_attention_qkv`` at S=577, W=1024
  returns the batch-chunked reference composition (as JAX's does, which it
  is held to at 1e-5) and never calls the kernel, while S=257 at the same
  width calls it once.
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
from aiic_tpu_torch.probes import mxu_probe

torch.set_num_threads(2)

WIDTH, HEADS = 128, 2


@pytest.mark.parametrize("seq,masked", [(1, False), (13, False), (63, False), (64, False),
                                        (65, False), (77, True), (129, False), (197, False)],
                         ids=["S1", "S13", "S63", "S64", "S65", "S77_causal", "S129", "S197"])
def test_attention_qkv_bwd_ul_form_matches_jax_kernel(seq, masked):
    rng = np.random.default_rng(110 + seq)
    qkv = rng.standard_normal((2, seq, 3 * WIDTH)).astype(np.float32)
    g = rng.standard_normal((2, seq, WIDTH)).astype(np.float32)
    mj = jnp.asarray(jax_causal_mask(seq) if masked else np.zeros((seq, seq)), jnp.float32)
    run = jax.jit(functools.partial(jax_attention.fused_attention_qkv_bwd, heads=HEADS,
                                    interpret=True))
    ref = np.asarray(run(jnp.asarray(qkv), mj, jnp.asarray(g)))
    out = attention.fused_attention_qkv_bwd_ul_ref(torch.from_numpy(qkv),
                                                   causal_mask(seq) if masked else None,
                                                   torch.from_numpy(g), heads=HEADS)
    assert out.dtype == torch.float32 and out.shape == qkv.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_quant_scales_from_extremes_are_the_plain_scales():
    x = mxu_probe.inputs("cpu", steps=1)[0]
    got = mxu_probe.quant_scales_from_extremes(x, mxu_probe.INNER)
    assert got.shape == (mxu_probe.INNER, x.shape[0])
    for i in range(mxu_probe.INNER):
        assert torch.equal(got[i], mxu_probe.quant_scale(x, i).squeeze(-1)), i


def _no_library():
    raise AssertionError("the argument check must raise before the library loads")


def _bwd(dtype, form, seq=77, heads=8, width=512):
    return lambda: attention._fused_attention_qkv_bwd_cuda(
        torch.zeros((1, seq, 3 * width), dtype=dtype), None,
        torch.zeros((1, seq, width), dtype=dtype), heads, form)


def _probe(name, form, rows=128, depth=768, cols=256, xdtype=None):
    xdt, wdt, _ = mxu_probe._TYPES[name]
    return lambda: mxu_probe._probe_cuda(name, torch.zeros((rows, depth), dtype=xdtype or xdt),
                                         torch.zeros((depth, cols), dtype=wdt), 3, form)


def _row7(dtype, form, seq=197, heads=12, width=768):
    return lambda: attention._fused_attention_qkv_cuda(
        torch.zeros((1, seq, 3 * width), dtype=dtype), None, heads, form)


def _row6(dtype, form, seq=197, heads=12, dim=64):
    q = torch.zeros((1, seq, heads, dim), dtype=dtype)
    return lambda: attention._fused_attention_cuda(q, q, q, None, form)


REFUSED = {
    "row7_scalar_bf16": _row7(torch.bfloat16, "scalar"),  # the scalar form is fp32's
    "row7_unknown_form": _row7(torch.float32, "mma"),
    "row7_scalar_s577": _row7(torch.float32, "scalar", seq=577),  # K, V exceed shared memory
    "row7_tiled_head_dim_32": _row7(torch.float32, None, heads=24),
    "row6_scalar_bf16": _row6(torch.bfloat16, "scalar"),
    "row6_scalar_d8": _row6(torch.float32, "scalar", dim=8),  # D=8 has the scalar core alone
    "row6_scalar_s577": _row6(torch.float32, "scalar", seq=577),
    "row6_unknown_form": _row6(torch.float32, "tiled_v2"),
    "bwd_tiled_bf16": _bwd(torch.bfloat16, "tiled"),  # the register-tiled form is fp32's
    "bwd_mma_fp32": _bwd(torch.float32, "mma"),  # the tensor-core form is bf16's
    "bwd_unknown_form": _bwd(torch.float32, "wgmma"),
    "bwd_tiled_head_dim_32": _bwd(torch.float32, "tiled", heads=16),
    "probe_wgmma_rows_64": _probe("mxu_bf16", "wgmma", rows=64),  # 128-row blocks
    "probe_wgmma_cols_128": _probe("mxu_i8", "wgmma", cols=128),  # 256-column blocks
    "probe_wgmma_i8_depth_64": _probe("mxu_i8", "wgmma", depth=64),  # 128-B K slices of int8
    "probe_wgmma_quant_depth_896": _probe("mxu_i8_quant", "wgmma", depth=896),  # w^T resident
    "probe_unknown_form": _probe("mxu_bf16", "tma"),
    "probe_wgmma_i8_bf16_x": _probe("mxu_i8", "wgmma", xdtype=torch.bfloat16),  # the wrong dtype
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_new_forms_refuse_what_they_do_not_take(monkeypatch, case):
    monkeypatch.setattr(attention, "load_library", _no_library)
    monkeypatch.setattr(mxu_probe, "load_library", _no_library)
    with pytest.raises(ValueError):
        REFUSED[case]()


def test_probe_forms_take_the_probe_geometry(monkeypatch):
    """The wgmma form's checks pass the probe's own geometry (one row block
    of 128 rows, and i8_quant's 64): the call gets as far as the library."""
    monkeypatch.setattr(mxu_probe, "load_library", _no_library)
    for name in ("mxu_bf16", "mxu_i8", "mxu_i8_quant"):
        for rows in ((64, 128) if name == "mxu_i8_quant" else (128,)):
            with pytest.raises(AssertionError, match="before the library loads"):
                _probe(name, "wgmma", rows=rows, cols=mxu_probe.M)()


@pytest.mark.parametrize("row", ["row7", "row6"])
def test_f32_tiled_core_takes_any_seq(monkeypatch, row):
    """fp32 at D=64 on the register-tiled core passes its checks at S=577
    (no shared-memory refusal), and so does the scalar form at S=197: each
    call gets as far as the library."""
    monkeypatch.setattr(attention, "load_library", _no_library)
    make = _row7 if row == "row7" else _row6
    for call in (make(torch.float32, None, seq=577, heads=16, **(
            {"width": 1024} if row == "row7" else {})), make(torch.float32, "scalar")):
        with pytest.raises(AssertionError, match="before the library loads"):
            call()


def test_fp32_row7_routing_follows_the_jax_planner(monkeypatch):
    calls = []
    monkeypatch.setattr(attention, "route", lambda name, x: True)
    monkeypatch.setattr(attention, "_fused_attention_qkv_cuda",
                        lambda qkv, mask, heads: calls.append(qkv.shape[1]) or
                        torch.zeros(qkv.shape[:2] + (qkv.shape[2] // 3,)))
    rng = np.random.default_rng(577)
    qkv = rng.standard_normal((2, 577, 3 * 1024)).astype(np.float32)
    before = attention.fused_attention_qkv.launches
    out = attention.fused_attention_qkv(torch.from_numpy(qkv), None, heads=16)
    assert calls == [] and attention.fused_attention_qkv.launches == before
    assert torch.equal(out, attention._attention_qkv_xla_chunked(torch.from_numpy(qkv), None, 16))
    ref = np.asarray(jax_attention.fused_attention_qkv(jnp.asarray(qkv), None, heads=16))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    attention.fused_attention_qkv(torch.zeros((2, 257, 3 * 1024)), None, heads=16)
    assert calls == [257] and attention.fused_attention_qkv.launches == before + 1


@pytest.mark.parametrize("seq", [257, 577])
def test_fp32_row6_takes_the_kernel_at_any_seq(monkeypatch, seq):
    """JAX's row 6 has no planner: with the card route forced, fp32
    ``flash_attention`` at D=64 reaches the register-tiled form (no form
    asked) once, counted, at S past the scalar core's shared memory too."""
    calls = []
    monkeypatch.setattr(attention, "route", lambda name, x: True)
    monkeypatch.setattr(attention, "_fused_attention_cuda",
                        lambda q, k, v, mask, form=None: calls.append((q.shape[1], form)) or
                        torch.zeros_like(q))
    q = torch.zeros((1, seq, 2, 64))
    before = attention.fused_attention.launches
    out = attention.flash_attention(q, q, q, causal_mask(seq))
    assert calls == [(seq, None)] and attention.fused_attention.launches == before + 1
    assert out.shape == q.shape
