"""The GEMM stage of rows 1-5 and 10 (``quant.gemm_stage``) and the K-major
int8 copies its ``wgmma`` form reads, on the CPU.

- ``quant.kmajor`` makes w^T once per weight and caches it on the tensor
  that owns the weight's storage: the copy equals the transpose exactly,
  a layer's fresh view of a stacked weight finds the same copy, an in-place
  change makes a new one, and the parameter tree keeps JAX's keys.
- The stage's plain version, composed as rows 1 and 2 compose it (row
  quantizer, product with its epilogue, core, product), gives the rows'
  plain versions bit for bit, and holds the JAX kernels (Pallas in
  interpret mode, as tests/test_ops.py runs them) at the bars of
  tests/test_torch_quant.py: >= 99% of bf16 elements within 1 bf16 ULP and
  every row's cosine >= 0.9999.
- Row 3's c_proj with the chunk sums folded in (``chunk_residual``): its
  plain version is numpy's float32 sum in chunk order bit for bit; row 3
  composed from the stage's plain calls (LN row quantizer, gelu, the
  per-(row, chunk) quantizer, chunk_residual) is ``int8_ln_mlp_chunked`` bit
  for bit and holds JAX's ``_int8_mlp_rows(n_chunks=C)`` (compiled with
  excess precision off) at the bar above; the kernel wrappers refuse a chunk
  of the hidden axis that is not a whole number of the stage's 128-B
  K-slices before anything is built or launched.
- The bf16 half-blocks (rows 5 and 10) composed from the stage's plain
  calls as their form 0 runs them (LN rounded to bf16, ``bias`` or
  ``bias_gelu``, the packed core for row 5, ``out_proj``) give
  ``fused_ln_qkv_attention`` and ``fused_ln_mlp`` bit for bit and hold the
  JAX kernels (interpret mode, excess precision off) at the bar above; each
  per-element epilogue holds float64 numpy; rows 5 and 10 and the stage
  refuse an unknown ``form`` before the library is loaded.
- The text block's two products on the stage (rows 12 and 14's backward):
  ``dot_t``, g . W^T with W (N, K) as it lies (the bf16 K-major B), against
  float64 numpy at K = 512 and 2048 and bit for bit the (K, N) product of
  the transposed copy; ``chunk_rowscale``, the chunked int8 cotangent
  product with its chunk sums folded (C = 1, 2, 6), bit for bit numpy's
  float32 sum in chunk order; a chunk off the 128-B slices and an unknown
  form refused before anything is built.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiic_tpu.models.clip import causal_mask as jax_causal_mask
from aiic_tpu.models.config import TINY_TEST
from aiic_tpu.models.init import flatten_params, init_clip_params
from aiic_tpu.ops import attention as jax_attention
from aiic_tpu.ops import mlp as jax_mlp
from aiic_tpu.ops import quant as jax_quant
from aiic_tpu_torch.models.clip import causal_mask
from aiic_tpu_torch.models.init import params_from_numpy
from aiic_tpu_torch.ops import attention, mlp, quant

torch.set_num_threads(2)


def _bf16_close(ours, ref):
    o = ours.float().numpy().reshape(-1, ours.shape[-1])
    r = np.asarray(ref.astype(jnp.float32)).reshape(o.shape)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126))) - 7)
    assert (np.abs(o - r) <= ulp).mean() >= 0.99
    cos = (o * r).sum(-1) / (np.linalg.norm(o, axis=-1) * np.linalg.norm(r, axis=-1))
    assert cos.min() >= 0.9999, cos.min()


def _int8(rng, *shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


@pytest.mark.parametrize("layout", ["stacked", "alone"])
def test_kmajor_copies_are_the_transposes(layout):
    rng = np.random.default_rng(0)
    stacked = _int8(rng, 3, 64, 256)
    weights = [stacked[i] for i in range(3)] if layout == "stacked" else [_int8(rng, 64, 256)]
    for w in weights:
        wt = quant.kmajor(w)
        assert wt.dtype == torch.int8 and wt.is_contiguous() and tuple(wt.shape) == (256, 64)
        assert torch.equal(wt, w.t())
        assert quant.kmajor(w) is wt
    if layout == "stacked":  # a layer's fresh view finds its copy; each layer has its own
        assert quant.kmajor(stacked[1]) is quant.kmajor(weights[1])
        assert quant.kmajor(stacked[0]) is not quant.kmajor(stacked[2])
    w = weights[0]
    first = quant.kmajor(w)
    w.add_(1)  # an in-place change: a new copy, equal to the new transpose
    again = quant.kmajor(w)
    assert again is not first and torch.equal(again, w.t())


def test_kmajor_takes_inference_tensors():
    """A weight made under inference_mode (the large-S path's head-major
    copy of wqkv_q is) keeps no version counter; its copy is cached all the
    same."""
    with torch.inference_mode():
        w = _int8(np.random.default_rng(1), 64, 384).clone()
        wt = quant.kmajor(w)
        assert torch.equal(wt, w.t()) and quant.kmajor(w) is wt
    assert quant.kmajor(w) is wt


def test_kmajor_keeps_the_parameter_tree_keys():
    """The bridged tree and quantize_model's output equal JAX's key for key
    after every int8 weight of every layer has its K-major copy."""
    jp = init_clip_params(jax.random.PRNGKey(0), TINY_TEST)
    bridged = params_from_numpy(flatten_params(jp))
    ours = quant.quantize_model(bridged)
    for tower in ("visual", "text"):
        blocks = ours[tower]["blocks"]
        for i in range(blocks["ln1"]["scale"].shape[0]):
            for w in (blocks["attn_q"]["wqkv_q"][i], blocks["mlp_q"]["w1_q"][i],
                      blocks["mlp_q"]["w2_q"][i]):
                assert torch.equal(quant.kmajor(w), w.t())

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
        return out

    assert set(flat(bridged)) == set(flatten_params(jp))
    assert set(flat(ours)) == set(flatten_params(jax_quant.quantize_model(jp)))


def _weights(rng, w, m):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"ln_s": 1 + 0.1 * f(w), "ln_b": 0.1 * f(w), "wqkv": 0.1 * f(w, 3 * w),
            "bqkv": 0.1 * f(3 * w), "wo": 0.1 * f(w, w), "bo": 0.1 * f(w), "w1": 0.08 * f(w, m),
            "b1": 0.1 * f(m), "w2": 0.08 * f(m, w), "b2": 0.1 * f(w)}


def _row_quant_ln(x, ln_s, ln_b):
    rows, width = x.shape[0] * x.shape[1], x.shape[2]
    h = attention._ln_fp32(x.float().reshape(rows, width), ln_s.reshape(1, width),
                           ln_b.reshape(1, width), 1e-5)
    return quant._row_quant(h)


@pytest.mark.parametrize("bsz", [1, 3])
def test_stage_composes_row2(bsz):
    rng = np.random.default_rng(1)
    s, w, m = 16, 64, 256
    p = _weights(rng, w, m)
    x = torch.from_numpy(rng.standard_normal((bsz, s, w)).astype(np.float32)).to(torch.bfloat16)
    w1_q, s1 = jax_quant.quantize_weight(jnp.asarray(p["w1"]))
    w2_q, s2 = jax_quant.quantize_weight(jnp.asarray(p["w2"]))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    args = (t(p["ln_s"]), t(p["ln_b"]), t(w1_q), t(s1), t(p["b1"]), t(w2_q), t(s2), t(p["b2"]))
    hq, hs = _row_quant_ln(x, args[0], args[1])
    y = quant.gemm_stage(hq, args[2], "gelu", row_scale=hs, col_scale=args[3], bias=args[4])
    assert y.dtype == torch.float32
    yq, ys = quant._row_quant(y)
    out = quant.gemm_stage(yq, args[5], "residual", row_scale=ys, col_scale=args[6],
                           bias=args[7], x=x.reshape(bsz * s, w)).reshape(x.shape)
    assert torch.equal(out, quant.int8_ln_mlp(x, *args))
    ref = jax_quant.int8_ln_mlp(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), p["ln_s"],
                                p["ln_b"], w1_q, s1, p["b1"], w2_q, s2, p["b2"], interpret=True)
    _bf16_close(out, ref)


@pytest.mark.parametrize("use_mask", [False, True], ids=["nomask", "causal"])
def test_stage_composes_row1(use_mask):
    rng = np.random.default_rng(2)
    b, s, w, h = 2, 77, 64, 4
    p = _weights(rng, w, 4 * w)
    x = torch.from_numpy(rng.standard_normal((b, s, w)).astype(np.float32)).to(torch.bfloat16)
    wq, sq = jax_quant.quantize_weight(jnp.asarray(p["wqkv"]))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    mask = causal_mask(s) if use_mask else None
    wo = t(p["wo"]).to(torch.bfloat16)
    hq, hs = _row_quant_ln(x, t(p["ln_s"]), t(p["ln_b"]))
    qkv = quant.gemm_stage(hq, t(wq), "qkv", row_scale=hs, col_scale=t(sq), bias=t(p["bqkv"]))
    core = attention.fused_attention_qkv(qkv.reshape(b, s, 3 * w), mask, heads=h)
    out = quant.gemm_stage(core.reshape(b * s, w), wo, "out_proj", bias=t(p["bo"]),
                           x=x.reshape(b * s, w)).reshape(x.shape)
    want = quant.int8_ln_qkv_attention(x, t(p["ln_s"]), t(p["ln_b"]), t(wq), t(sq),
                                       t(p["bqkv"]), wo, t(p["bo"]), mask, heads=h)
    assert torch.equal(out, want)
    ref = jax_quant.int8_ln_qkv_attention(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), p["ln_s"], p["ln_b"], wq, sq,
        p["bqkv"], p["wo"], p["bo"], jax_causal_mask(s) if use_mask else None, heads=h,
        interpret=True)
    _bf16_close(out, ref)


# The per-element epilogues; the folds (chunk_residual, chunk_rowscale) and
# the text block's transposed-weight product (dot_t) have their own tests
# below.
PER_ELEMENT = sorted(set(quant.STAGE_EPILOGUES) - {"chunk_residual", "chunk_rowscale", "dot_t"})
EXACT_BF16 = {"xla_allow_excess_precision": False}


@pytest.mark.parametrize("epilogue", PER_ELEMENT)
def test_stage_plain_version_matches_numpy(epilogue):
    """Each epilogue against float64 numpy on the same product: int8 exact
    before the epilogue, every result within one rounding of its type."""
    rng = np.random.default_rng(3)
    rows, k, n = 13, 256, 128
    x = rng.standard_normal((rows, n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    if epilogue in quant.BF16_EPILOGUES:
        a = rng.standard_normal((rows, k)).astype(np.float32)
        w = (rng.standard_normal((k, n)) / 16).astype(np.float32)
        at = torch.from_numpy(a).to(torch.bfloat16)
        wt = torch.from_numpy(w).to(torch.bfloat16)
        out = quant.gemm_stage(at, wt, epilogue, bias=torch.from_numpy(bias),
                               x=torch.from_numpy(x).to(torch.bfloat16))
        xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
        v = at.double().numpy() @ wt.double().numpy() + bias
        ref = {"out_proj": xb + v, "bias": v, "bias_gelu": v / (1 + np.exp(-1.702 * v))}[epilogue]
    else:
        a, w = _int8(rng, rows, k), _int8(rng, k, n)
        rs = rng.random(rows).astype(np.float32) / 100
        cs = rng.random(n).astype(np.float32) / 100
        xb = torch.from_numpy(x).to(torch.bfloat16)
        out = quant.gemm_stage(a, w, epilogue, row_scale=torch.from_numpy(rs),
                               col_scale=torch.from_numpy(cs), bias=torch.from_numpy(bias), x=xb)
        v = (a.numpy().astype(np.float64) @ w.numpy().astype(np.float64)) * rs[:, None] \
            * cs[None] + bias
        ref = {"qkv": v, "gelu": v / (1 + np.exp(-1.702 * v)),
               "residual": xb.double().numpy() + v}[epilogue]
    assert out.shape == (rows, n)
    assert out.dtype == (torch.float32 if epilogue == "gelu" else torch.bfloat16)
    tol = 2.0 ** -23 * 8 if epilogue == "gelu" else 2.0 ** -8
    np.testing.assert_allclose(out.double().numpy(), ref, rtol=tol, atol=1e-5)


def _ln_bf16(x, ln_s, ln_b):
    rows, width = x.shape[0] * x.shape[1], x.shape[2]
    return attention._ln_fp32(x.float().reshape(rows, width), ln_s.reshape(1, width),
                              ln_b.reshape(1, width), 1e-5).to(torch.bfloat16)


@pytest.mark.parametrize("use_mask", [False, True], ids=["nomask", "causal"])
def test_stage_composes_row5(use_mask):
    """Row 5 (bf16) from the stage's plain calls as its form 0 runs it: LN
    rounded to bf16, the QKV product with its bias (``bias``), the packed
    core, the out-projection with the residual (``out_proj``); bit for bit
    ``fused_ln_qkv_attention`` and at the bf16 bar of the JAX kernel
    (interpret mode, excess precision off)."""
    rng = np.random.default_rng(8)
    b, s, w, h = 2, 77, 64, 4
    p = _weights(rng, w, 4 * w)
    x = torch.from_numpy(rng.standard_normal((b, s, w)).astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy
    mask = causal_mask(s) if use_mask else None
    wqkv, wo = t(p["wqkv"]).to(torch.bfloat16), t(p["wo"]).to(torch.bfloat16)
    hb = _ln_bf16(x, t(p["ln_s"]), t(p["ln_b"]))
    qkv = quant.gemm_stage(hb, wqkv, "bias", bias=t(p["bqkv"]))
    assert qkv.dtype == torch.bfloat16 and qkv.shape == (b * s, 3 * w)
    core = attention.fused_attention_qkv(qkv.reshape(b, s, 3 * w), mask, heads=h)
    out = quant.gemm_stage(core.reshape(b * s, w), wo, "out_proj", bias=t(p["bo"]),
                           x=x.reshape(b * s, w)).reshape(x.shape)
    want = attention.fused_ln_qkv_attention(x, t(p["ln_s"]), t(p["ln_b"]), t(p["wqkv"]),
                                            t(p["bqkv"]), t(p["wo"]), t(p["bo"]), mask, heads=h)
    assert torch.equal(out, want)
    run = jax.jit(functools.partial(jax_attention.fused_ln_qkv_attention, heads=h,
                                    interpret=True), compiler_options=EXACT_BF16)
    ref = run(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), p["ln_s"], p["ln_b"],
              p["wqkv"], p["bqkv"], p["wo"], p["bo"], jax_causal_mask(s) if use_mask else None)
    _bf16_close(out, ref)


@pytest.mark.parametrize("bsz", [1, 3])
def test_stage_composes_row10(bsz):
    """Row 10 (bf16) from the stage's plain calls as its form 0 runs it: LN
    rounded to bf16, c_fc with its bias and the exp2 gelu rounded once
    (``bias_gelu``), c_proj with the residual (``out_proj``, K = 4W); bit for
    bit ``fused_ln_mlp`` and at the bf16 bar of the JAX kernel."""
    rng = np.random.default_rng(9)
    s, w, m = 16, 64, 256
    p = _weights(rng, w, m)
    x = torch.from_numpy(rng.standard_normal((bsz, s, w)).astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy
    w1, w2 = t(p["w1"]).to(torch.bfloat16), t(p["w2"]).to(torch.bfloat16)
    hb = _ln_bf16(x, t(p["ln_s"]), t(p["ln_b"]))
    y = quant.gemm_stage(hb, w1, "bias_gelu", bias=t(p["b1"]))
    assert y.dtype == torch.bfloat16 and y.shape == (bsz * s, m)
    out = quant.gemm_stage(y, w2, "out_proj", bias=t(p["b2"]),
                           x=x.reshape(bsz * s, w)).reshape(x.shape)
    names = ("ln_s", "ln_b", "w1", "b1", "w2", "b2")
    assert torch.equal(out, mlp.fused_ln_mlp(x, *(t(p[k]) for k in names)))
    ref = jax.jit(functools.partial(jax_mlp.fused_ln_mlp, interpret=True),
                  compiler_options=EXACT_BF16)(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), *(p[k] for k in names))
    _bf16_close(out, ref)


@pytest.mark.parametrize("kernel", ["fused_ln_qkv_attention", "fused_ln_mlp", "gemm_stage",
                                    "gemm_stage_dot_t"])
def test_bf16_forms_refuse_an_unknown_form(monkeypatch, kernel):
    """Rows 5 and 10 and the stage take form "wgmma" (the route) or "wmma"
    (the first design) alone: any other is refused with a clear error
    before the library is loaded; nothing falls back to another form."""
    def no_library():
        raise AssertionError("the kernel library was reached before the check")

    for module in (attention, mlp, quant):
        monkeypatch.setattr(module, "load_library", no_library)
    rng = np.random.default_rng(10)
    w = 128
    p = _weights(rng, w, 4 * w)
    t = torch.from_numpy
    xb = torch.from_numpy(rng.standard_normal((1, 16, w)).astype(np.float32)).to(torch.bfloat16)
    if kernel == "fused_ln_qkv_attention":
        call = lambda: attention._fused_ln_qkv_attention_cuda(  # noqa: E731
            xb, t(p["ln_s"]), t(p["ln_b"]), t(p["wqkv"]), t(p["bqkv"]), t(p["wo"]), t(p["bo"]),
            None, 2, 1e-5, form="scalar")
    elif kernel == "fused_ln_mlp":
        call = lambda: mlp._fused_ln_mlp_cuda(  # noqa: E731
            xb, t(p["ln_s"]), t(p["ln_b"]), t(p["w1"]), t(p["b1"]), t(p["w2"]), t(p["b2"]), 1e-5,
            form="wmma_split")
    elif kernel == "gemm_stage":
        call = lambda: quant._gemm_stage_cuda(  # noqa: E731
            xb.reshape(16, w), t(p["w1"]).to(torch.bfloat16), "bias", None, None, t(p["b1"]),
            None, form="mma")
    else:
        call = lambda: quant._gemm_stage_cuda(  # noqa: E731
            xb.reshape(16, w), t(p["w1"]).t().to(torch.bfloat16), "dot_t", None, None, None,
            None, form="kmajor")
    with pytest.raises(ValueError, match="form"):
        call()


def test_stage_refuses_an_unknown_epilogue():
    a = torch.zeros((4, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="epilogue"):
        quant.gemm_stage(a, torch.zeros((128, 128), dtype=torch.int8), "relu")


@pytest.mark.parametrize("n_chunks", [2, 4])
def test_chunk_residual_plain_version_matches_numpy(n_chunks):
    """x + sum over c of acc_c·ys[:, c]·s2, in chunk order, then + b2: numpy's
    float32 ops in that order give the plain version's bits (each int32
    acc_c exact), and float64 agrees within one bf16 rounding."""
    rng = np.random.default_rng(4 + n_chunks)
    rows, k, n = 13, 512, 128
    chunk = k // n_chunks
    a, w = _int8(rng, rows, k), _int8(rng, k, n)
    ys = (rng.random((rows, n_chunks)) / 100).astype(np.float32)
    s2 = (rng.random(n) / 100).astype(np.float32)
    b2 = rng.standard_normal(n).astype(np.float32)
    xb = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)).to(torch.bfloat16)
    out = quant.gemm_stage(a, w, "chunk_residual", row_scale=torch.from_numpy(ys),
                           col_scale=torch.from_numpy(s2), bias=torch.from_numpy(b2), x=xb,
                           n_chunks=n_chunks)
    assert out.shape == (rows, n) and out.dtype == torch.bfloat16
    an, wn = a.numpy().astype(np.int64), w.numpy().astype(np.int64)
    total = xb.float().numpy()
    total64 = xb.double().numpy()
    for c in range(n_chunks):
        acc = an[:, c * chunk:(c + 1) * chunk] @ wn[c * chunk:(c + 1) * chunk]
        total = total + acc.astype(np.float32) * ys[:, c:c + 1] * s2
        total64 = total64 + acc * ys[:, c:c + 1].astype(np.float64) * s2
    assert torch.equal(out, torch.from_numpy(total + b2).to(torch.bfloat16))
    np.testing.assert_allclose(out.double().numpy(), total64 + b2, rtol=2.0 ** -8, atol=1e-5)


@pytest.mark.parametrize("k", [512, 2048])
def test_dot_t_plain_version_matches_numpy(k):
    """The text block's cotangent product g . W^T (``dot_t``, W (N, K) as the
    weight lies: the bf16 K-major B of the wgmma form) against float64 numpy
    at K = 512 and 2048: fp32 sums of exact bf16 products, within 1e-5 of
    the largest |entry|; and the same bits as the bf16 (K, N) product of the
    transposed copy, which only its layout tells apart."""
    rng = np.random.default_rng(11 + k)
    rows, n = 77, 384
    a = torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((n, k)) / 16).astype(np.float32)).to(torch.bfloat16)
    out = quant.gemm_stage(a, w, "dot_t")
    assert out.shape == (rows, n) and out.dtype == torch.float32
    ref = a.double().numpy() @ w.double().numpy().T
    assert np.abs(out.double().numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert torch.equal(out, a.float() @ w.t().contiguous().float())


@pytest.mark.parametrize("n_chunks", [1, 2, 6])
def test_chunk_rowscale_plain_version_matches_numpy(n_chunks):
    """Row 14's chunked dh2 product without its LoRA term
    (``chunk_rowscale``): from 0, each chunk's acc_c·rs[:, c] added in
    chunk order, fp32. numpy's float32 ops in that order give the plain
    version's bits (each int32 acc_c exact); float64 agrees within fp32
    rounding. C = 1 is the unchunked cotangent product (EpiRowScale's
    acc·rs)."""
    rng = np.random.default_rng(20 + n_chunks)
    rows, k, n = 13, 768, 128
    chunk = k // n_chunks
    a, w = _int8(rng, rows, k), _int8(rng, k, n)
    rs = (rng.random((rows, n_chunks)) / 100).astype(np.float32)
    out = quant.gemm_stage(a, w, "chunk_rowscale", row_scale=torch.from_numpy(rs),
                           n_chunks=n_chunks)
    assert out.shape == (rows, n) and out.dtype == torch.float32
    an, wn = a.numpy().astype(np.int64), w.numpy().astype(np.int64)
    total = np.zeros((rows, n), np.float32)
    total64, largest = np.zeros((rows, n)), 0.0
    for c in range(n_chunks):
        acc = an[:, c * chunk:(c + 1) * chunk] @ wn[c * chunk:(c + 1) * chunk]
        total = total + acc.astype(np.float32) * rs[:, c:c + 1]
        term = acc * rs[:, c:c + 1].astype(np.float64)
        total64, largest = total64 + term, max(largest, np.abs(term).max())
    assert torch.equal(out, torch.from_numpy(total))
    # two fp32 roundings a chunk (the product, the sum), each within half
    # an ULP of the largest term
    assert np.abs(out.double().numpy() - total64).max() <= 2 * n_chunks * 2.0 ** -24 * largest


@pytest.mark.parametrize("n_chunks", [2, 4])
def test_stage_composes_row3(n_chunks):
    """Row 3 from the stage's plain calls: the LN row quantizer, c_fc with
    gelu, y quantized per (row, chunk) as the (rows·C, 4W/C) matrix it is,
    then chunk_residual; bit for bit ``int8_ln_mlp_chunked`` and at the bf16
    bar of JAX's _int8_mlp_rows(n_chunks=C)."""
    rng = np.random.default_rng(6)
    b, s, w, m = 3, 16, 128, 512
    p = _weights(rng, w, m)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    x[1, 2] = 0.0  # with ln_b = 0 an all-zero LN row: the 1e-6 scale floor
    p["ln_b"][:] = 0.0
    xb = torch.from_numpy(x).to(torch.bfloat16)
    w1_q, s1 = jax_quant.quantize_weight(jnp.asarray(p["w1"]))
    w2_q, s2 = jax_quant.quantize_weight(jnp.asarray(p["w2"]))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    args = (t(p["ln_s"]), t(p["ln_b"]), t(w1_q), t(s1), t(p["b1"]), t(w2_q), t(s2), t(p["b2"]))
    rows = b * s
    hq, hs = _row_quant_ln(xb, args[0], args[1])
    y = quant.gemm_stage(hq, args[2], "gelu", row_scale=hs, col_scale=args[3], bias=args[4])
    yq, ys = quant._row_quant(y.reshape(rows * n_chunks, m // n_chunks))
    out = quant.gemm_stage(yq.reshape(rows, m), args[5], "chunk_residual",
                           row_scale=ys.reshape(rows, n_chunks), col_scale=args[6], bias=args[7],
                           x=xb.reshape(rows, w), n_chunks=n_chunks).reshape(xb.shape)
    assert torch.equal(out, quant.int8_ln_mlp_chunked(xb, *args, n_chunks=n_chunks))
    run = jax.jit(functools.partial(jax_quant._int8_mlp_rows, eps=1e-5, n_chunks=n_chunks),
                  compiler_options=EXACT_BF16)
    ref = run(jnp.asarray(x.reshape(rows, w)).astype(jnp.bfloat16), p["ln_s"].reshape(1, w),
              p["ln_b"].reshape(1, w), w1_q, s1.reshape(1, m), p["b1"].reshape(1, m), w2_q,
              s2.reshape(1, w), p["b2"].reshape(1, w))
    _bf16_close(out.reshape(rows, w), ref)


def _refused_before_a_launch(monkeypatch, call):
    """call() raises ValueError naming the 128-deep chunk, and nothing was
    built or launched first."""
    def no_library():
        raise AssertionError("the kernel library was reached before the check")

    monkeypatch.setattr(quant, "load_library", no_library)
    with pytest.raises(ValueError, match="multiple of 128"):
        call()


@pytest.mark.parametrize("kernel", ["int8_ln_mlp_chunked", "int8_block", "gemm_stage",
                                    "gemm_stage_rowscale"])
def test_wgmma_forms_refuse_a_chunk_off_the_slices(monkeypatch, kernel):
    """4W/C = 64: not a whole number of the wgmma stage's 128-B K-slices.
    The launch functions that the public wrappers call for a CUDA tensor
    refuse it with a clear error, before the library is loaded; they do not
    fall back."""
    rng = np.random.default_rng(7)
    w, m, n_chunks = 128, 512, 8
    p = _weights(rng, w, m)
    xb = torch.from_numpy(rng.standard_normal((1, 16, w)).astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy
    w1_q, s1 = quant.quantize_weight(t(p["w1"]))
    w2_q, s2 = quant.quantize_weight(t(p["w2"]))
    mlp_w = (t(p["ln_s"]), t(p["ln_b"]), w1_q, s1, t(p["b1"]), w2_q, s2, t(p["b2"]))
    if kernel == "int8_ln_mlp_chunked":
        call = lambda: quant._int8_ln_mlp_cuda(xb, *mlp_w, 1e-5, n_chunks)  # noqa: E731
    elif kernel == "int8_block":
        wqkv_q, sqkv = quant.quantize_weight(t(p["wqkv"]))
        attn_w = (t(p["ln_s"]), t(p["ln_b"]), wqkv_q, sqkv, t(p["bqkv"]),
                  t(p["wo"]).to(torch.bfloat16), t(p["bo"]), None)
        call = lambda: quant._int8_block_cuda(xb, attn_w, mlp_w, 2, 1e-5, n_chunks)  # noqa: E731
    elif kernel == "gemm_stage":
        yq = _int8(rng, 16, m)
        call = lambda: quant._gemm_stage_cuda(  # noqa: E731
            yq, w2_q, "chunk_residual", torch.ones(16, n_chunks), s2, t(p["b2"]),
            xb.reshape(16, w), n_chunks=n_chunks)
    else:
        yq = _int8(rng, 16, m)
        call = lambda: quant._gemm_stage_cuda(  # noqa: E731
            yq, w2_q, "chunk_rowscale", torch.ones(16, n_chunks), None, None, None,
            n_chunks=n_chunks)
    _refused_before_a_launch(monkeypatch, call)
