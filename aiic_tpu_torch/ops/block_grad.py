"""The whole training text block, forward and backward — the port of
``aiic_tpu.ops.block_grad``: the unquantized kernel pair and its int8
(serving-numerics) variant.

The block being differentiated (the training text block with LoRA on the
reference attach set ``out_proj``, ``c_fc``, ``c_proj``; no dropout):

    h1 = LN1(x);  qkv = h1 Wqkv + bqkv
    a  = attention(qkv)                   (clamped no-max exp2 softmax)
    y1 = x + a Wo + bo + s (a Ao) Bo
    h2 = LN2(y1); f = h2 W1 + b1 + s (h2 Af) Bf
    u  = f sigmoid(1.702 f)
    y  = y1 + u W2 + b2 + s (u Ap) Bp

- ``text_block_fwd``: (B, S, W) -> (B, S, W) (TPU kernels
  ``_text_block_fwd_kernel`` and ``_text_block_fwd_chunk_kernel``); kernel
  ``csrc/text_block.cuh``, plain version ``text_block_fwd_ref``.
- ``text_block_bwd``: (x, dy) -> (dx, the six LoRA cotangents), recomputing
  every forward intermediate from x (TPU kernels ``_text_block_bwd_kernel``
  and ``_text_block_bwd_chunk_kernel``); kernel ``csrc/text_block.cuh``, plain
  version ``text_block_bwd_ref``.
- ``TextBlockLoRA`` / ``text_block_lora``: the autograd pairing of the two
  (``text_block_lora``'s custom VJP). The backbone is frozen: it gets no
  gradient, nor does the mask.
- ``text_block_supported``: the JAX package's gate for the whole-block path.

The plain versions keep the TPU kernels' rounding contract: every product
casts both operands to the compute dtype (x's dtype) and sums in fp32; the
LN vectors, biases and LoRA factors are cast to the compute dtype
(``_weight_operands``); LN statistics are fp32 with eps 1e-5; scores use the
clamped no-max exp2 softmax with ``scale·log2 e`` rounded to the compute
dtype and the 1e-38 denominator guard, and the probabilities are normalized
before p·V; quick-gelu is fp32 ``f·sigmoid(1.702 f)``; the LoRA cotangents
come out in fp32. The chunked TPU kernels (the fp32 plan at ViT-B/16) split
only the MLP hidden axis, so the same math covers both plans up to the order
of fp32 sums.

The int8 variant (``text_block_fwd_int8``, ``text_block_bwd_int8``,
``TextBlockLoRAInt8`` / ``text_block_lora_int8``; TPU kernels
``_text_block_{fwd,bwd}_int8_kernel`` and their chunked forms; kernels
``csrc/text_block_int8.cu``) trains against the int8 serving numerics: QKV,
c_fc and c_proj are int8 x int8 -> int32 products of the fp32 activation
row-quantized (``h1f``, ``h2f``, ``u``, never rounded to bf16 first) against
the per-output-channel int8 weights, dequantized as ``(acc·rowscale)·colscale``
before the bias; ``wo``, the core and the LoRA deltas stay in the compute
dtype. Its backward is the straight-through estimator, each cotangent
product through an int8 weight itself int8: ``rowquant(g·colscale) @ Wqᵀ``
times the row scale, for ``dy·s2``, ``dfq·s1`` and ``dqkv·sqkv``. Its plans
(``text_block_int8_plan``) differ in one place: with ``n_chunks > 1``
``dfq·s1`` is quantized per (row, hidden-axis chunk) and the chunks'
dequantized products are summed in chunk order. The plain versions run the
integer products exactly, through float64 (``quant._int_matmul``).

Each wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

import torch

from aiic_tpu_torch.adapters.lora import ATTACH_POINTS as POINTS
from aiic_tpu_torch.ops._build import (
    check, counted, form_code, load_library, mask_arg, ptr, route,
)
from aiic_tpu_torch.ops.attention import (
    LOG2E, _HEAD_DIM, _denom_guard, _qconst, _split_heads, exp2_rows, no_tf32,
)
from aiic_tpu_torch.ops.quant import STAGE_SLICE, _int_matmul, _row_quant, kmajor

Params = Dict[str, Any]

# ---------------------------------------------------------------------------
# The JAX package's gates for the whole-block paths
# ---------------------------------------------------------------------------
#
# A copy of the pure arithmetic of aiic_tpu/ops/block_grad.py
# (_text_block_vmem_bytes, _text_block_chunk_vmem_bytes, text_block_plan,
# text_block_supported, and the int8 twins _int8_text_block_vmem_bytes,
# _int8_text_block_chunk_vmem_bytes, text_block_int8_plan,
# text_block_int8_supported). It mirrors the JAX package's ROUTING, so that
# one configuration runs the same math in both packages; it is not a memory
# plan for Hopper (the CUDA kernels tile for the card on their own). The
# int8 plan's chunk count does change the numerics (the backward's dfq
# quantization), so the int8 kernels take it.

_BLOCK_VMEM_BUDGET = 15 * 1024 * 1024
_INT8_BLOCK_VMEM_BUDGET = int(12.5 * 1024 * 1024)


def _text_block_vmem_bytes(group: int, seq: int, width: int, mlp_dim: int,
                           heads: int, itemsize: int) -> int:
    rows = group * seq
    weights = (4 * width * width + 2 * width * mlp_dim) * itemsize
    return weights + (
        3 * rows * width * itemsize
        + seq * seq * 4
        + rows * 3 * width * (4 + itemsize)
        + group * heads * seq * seq * 4
        + 3 * rows * mlp_dim * 4
        + 6 * rows * width * 4
    )


def _text_block_chunk_vmem_bytes(group: int, seq: int, width: int, mlp_dim: int,
                                 heads: int, n_chunks: int, itemsize: int) -> int:
    rows = group * seq
    chunk = mlp_dim // n_chunks
    return (
        4 * width * width * itemsize
        + 2 * 2 * width * chunk * itemsize
        + 2 * 3 * rows * width * itemsize
        + seq * seq * 4
        + rows * 3 * width * (4 + itemsize)
        + group * heads * seq * seq * 4
        + 2 * rows * width * itemsize
        + 2 * rows * width * 4
        + 5 * rows * chunk * 4
        + 2 * 64 * mlp_dim * 4
        + (1 << 20)
    )


def _int8_text_block_vmem_bytes(group: int, seq: int, width: int, mlp_dim: int,
                                heads: int) -> int:
    rows = group * seq
    weights = (3 * width * width + 2 * width * mlp_dim) + 2 * width * width
    return weights + (
        3 * rows * width * 2
        + seq * seq * 4
        + rows * 3 * width * (4 + 2)
        + group * heads * seq * seq * 4
        + 3 * rows * mlp_dim * 4
        + 6 * rows * width * 4
        + rows * (width + mlp_dim)
    )


def _int8_text_block_chunk_vmem_bytes(group: int, seq: int, width: int, mlp_dim: int,
                                      heads: int, n_chunks: int) -> int:
    rows = group * seq
    chunk = mlp_dim // n_chunks
    return (
        3 * width * width + 2 * width * width
        + 2 * 2 * width * chunk
        + 2 * 3 * rows * width * 2
        + seq * seq * 4
        + rows * 3 * width * (4 + 2)
        + group * heads * seq * seq * 4
        + rows * mlp_dim * 5
        + 2 * rows * width * 4
        + 2 * rows * width * (1 + 2)
        + 2 * rows * width * 4
        + 5 * rows * chunk * 4
        + 2 * 64 * mlp_dim * 4
        + (1 << 20)
    )


def _chunk_counts(mlp_dim: int):
    """Hidden-axis chunk counts whose chunk is a multiple of 128."""
    return [c for c in range(2, mlp_dim // 128 + 1) if not mlp_dim % c and not (mlp_dim // c) % 128]


def text_block_plan(seq: int, width: int, mlp_dim: int, heads: int,
                    itemsize: int = 2) -> Optional[Tuple[int, int]]:
    """(group, n_chunks) of the JAX package's planner, or None."""
    for g in (2, 1):
        if _text_block_vmem_bytes(g, seq, width, mlp_dim, heads, itemsize) <= _BLOCK_VMEM_BUDGET:
            return (g, 1)
        for c in _chunk_counts(mlp_dim):
            if _text_block_chunk_vmem_bytes(g, seq, width, mlp_dim, heads, c,
                                            itemsize) <= _BLOCK_VMEM_BUDGET:
                return (g, c)
    return None


def text_block_supported(seq: int, width: int, mlp_dim: int, heads: int,
                         itemsize: int = 2) -> bool:
    """True where the JAX package selects ``block_fused`` (some plan exists)."""
    return text_block_plan(seq, width, mlp_dim, heads, itemsize) is not None


def text_block_int8_plan(seq: int, width: int, mlp_dim: int, heads: int,
                         bsz: Optional[int] = None) -> Optional[Tuple[int, int]]:
    """(group, n_chunks) of the JAX package's int8 planner, or None."""
    for g in (2, 1):
        if bsz is not None and bsz % g:
            continue
        if _int8_text_block_vmem_bytes(g, seq, width, mlp_dim, heads) <= _INT8_BLOCK_VMEM_BUDGET:
            return (g, 1)
        for c in _chunk_counts(mlp_dim):
            if _int8_text_block_chunk_vmem_bytes(g, seq, width, mlp_dim, heads,
                                                 c) <= _INT8_BLOCK_VMEM_BUDGET:
                return (g, c)
    return None


def text_block_int8_supported(seq: int, width: int, mlp_dim: int, heads: int) -> bool:
    """True where some int8 plan exists: the trainer's ``quantize_text`` gate."""
    return text_block_int8_plan(seq, width, mlp_dim, heads) is not None


def _int8_chunks(x: torch.Tensor, mlp_dim: int, heads: int,
                 force_plan: Optional[Tuple[int, int]]) -> int:
    """The hidden-axis chunk count of the plan the JAX package runs for x."""
    if force_plan is not None:
        return force_plan[1]
    bsz, seq, width = x.shape
    plan = text_block_int8_plan(seq, width, mlp_dim, heads, bsz=bsz)
    if plan is None:
        raise ValueError(f"int8 text block geometry (S={seq}, W={width}, M={mlp_dim}) has no "
                         "plan in the JAX package, even hidden-axis-chunked at G=1")
    return plan[1]


def _card_chunks(name: str, mlp_dim: int, n_chunks: int, form: str) -> None:
    """Raises, before anything is built or launched, on a hidden-axis chunk
    that the card's form cannot take: the wgmma stage folds whole 128-B int8
    K-slices (``STAGE_SLICE``), the WMMA form splits 32-deep tiles. The JAX
    planner's chunks are multiples of 128; a forced plan may not be."""
    depth = STAGE_SLICE if form == "wgmma" else 32
    if n_chunks < 1 or mlp_dim % n_chunks or (mlp_dim // n_chunks) % depth:
        raise ValueError(f"{name} ({form}): the chunk M/C must be a multiple of {depth}, got "
                         f"M={mlp_dim}, C={n_chunks}")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

# The per-output-channel scale of each int8 weight.
_SCALE = {"wqkv": "sqkv", "w1": "s1", "w2": "s2"}


def _vectors(bp: Params, lora: Params, cdt: torch.dtype) -> Params:
    """LN vectors and biases as fp32 holding values rounded to the compute
    dtype, and the LoRA factors in it, as ``_weight_operands`` casts them."""
    vec = lambda v: v.reshape(-1).to(cdt).float()  # noqa: E731
    return {
        "ln1s": vec(bp["ln1"]["scale"]), "ln1b": vec(bp["ln1"]["bias"]),
        "ln2s": vec(bp["ln2"]["scale"]), "ln2b": vec(bp["ln2"]["bias"]),
        "bqkv": vec(bp["attn"]["bqkv"]), "bo": vec(bp["attn"]["bo"]),
        "b1": vec(bp["mlp"]["b1"]), "b2": vec(bp["mlp"]["b2"]),
        **{f"{p}_{ab}": lora[p][ab].to(cdt) for p in POINTS for ab in ("A", "B")},
    }


def _operands(bp: Params, lora: Params, cdt: torch.dtype) -> Params:
    """Every weight, bias, LN vector and LoRA factor cast to the compute
    dtype, as ``_weight_operands`` does; vectors come back as fp32 holding
    the rounded values."""
    return {**_vectors(bp, lora, cdt), "wqkv": bp["attn"]["wqkv"].to(cdt),
            "wo": bp["attn"]["wo"].to(cdt), "w1": bp["mlp"]["w1"].to(cdt),
            "w2": bp["mlp"]["w2"].to(cdt)}


def _int8_operands(bp: Params, qw: Params, lora: Params, cdt: torch.dtype) -> Params:
    """``_int8_weight_operands``: the int8 weights and their fp32 scales as
    given, ``wo`` in the compute dtype, vectors and factors as above."""
    return {**_vectors(bp, lora, cdt), "wo": bp["attn"]["wo"].to(cdt),
            **{k + "_q": qw[k + "_q"] for k in _SCALE},
            **{s: qw[s].reshape(-1).float() for s in _SCALE.values()}}


def _dot(a: torch.Tensor, b: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """a @ b with both operands rounded to ``cdt`` and fp32 sums."""
    return a.to(cdt).float() @ b.to(cdt).float()


def _q_dot(v: torch.Tensor, wq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_q_dot``: fp32 v row-quantized against int8 wq, exactly; returns
    (the int32 accumulator as fp32, the per-row scale)."""
    vq, vs = _row_quant(v)
    return _int_matmul(vq, wq).float(), vs


def _product(h: torch.Tensor, w: Params, key: str, cdt: torch.dtype) -> torch.Tensor:
    """h @ W for a backbone weight: in the compute dtype with fp32 sums, or,
    for an int8 weight, the fp32 h row-quantized, dequantized as
    (acc·rowscale)·colscale."""
    if key + "_q" in w:
        acc, hs = _q_dot(h, w[key + "_q"])
        return acc * hs * w[_SCALE[key]]
    return _dot(h, w[key], cdt)


def _product_t(g: torch.Tensor, w: Params, key: str, cdt: torch.dtype,
               n_chunks: int = 1) -> torch.Tensor:
    """g @ Wᵀ, the cotangent through a backbone weight: in the compute dtype,
    or for an int8 weight the straight-through estimator
    ``rowquant(g·colscale) @ Wqᵀ · rowscale``, quantized per (row, chunk) of
    the contraction and summed in chunk order when ``n_chunks > 1``."""
    if key + "_q" not in w:
        return _dot(g, w[key].t(), cdt)
    wq, gs = w[key + "_q"], g * w[_SCALE[key]]
    step = gs.shape[-1] // n_chunks
    out = 0.0
    for c in range(n_chunks):
        sl = slice(c * step, (c + 1) * step)
        acc, qs = _q_dot(gs[:, sl], wq[:, sl].t())
        out = out + acc * qs
    return out


def _ln_fwd(xf: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    """fp32 LN returning (out, xhat, inv) for the backward."""
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * inv
    return xhat * scale + bias, xhat, inv


def _ln_bwd(dh: torch.Tensor, xhat: torch.Tensor, inv: torch.Tensor, scale: torch.Tensor):
    g = dh * scale
    gm = g.mean(dim=-1, keepdim=True)
    gx = (g * xhat).mean(dim=-1, keepdim=True)
    return inv * (g - gm - xhat * gx)


def _core_probs(qkv: torch.Tensor, mask: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, 3W) in the compute dtype -> normalized fp32 probabilities
    (B, H, S, S): q scaled by the rounded ``scale·log2 e`` in the compute
    dtype, fp32 scores plus ``mask·log2 e``, clamped exp2, times the
    reciprocal of the guarded row sum."""
    q, k, _ = _split_heads(qkv, heads)
    qs = q * torch.tensor(q.shape[-1] ** -0.5 * LOG2E, dtype=q.dtype, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    p = exp2_rows(s + mask.float() * LOG2E)
    return p * (1.0 / _denom_guard(p.sum(dim=-1, keepdim=True)))


def _core_out(qkv: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """a = T(T(p)·v) (B, S, W) from the normalized fp32 probabilities."""
    bsz, seq, w3 = qkv.shape
    _, _, v = _split_heads(qkv, probs.shape[1])
    a = torch.einsum("bhqk,bkhd->bqhd", probs.to(qkv.dtype).float(), v.float())
    return a.to(qkv.dtype).reshape(bsz, seq, w3 // 3)


def block_core_fwd_ref(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                       heads: int) -> torch.Tensor:
    """The text block's core forward on a (B, S, 3W) projection in the
    compute dtype: (B, S, W), the probabilities normalized before p·V
    (``_core_probs``), any S. The plain version of the card's form-0 core
    forward (``csrc/block_core_fwd_mma.cuh``) and of
    ``block_core_fwd_kernel``."""
    no_tf32()
    x = qkv[..., : qkv.shape[-1] // 3]
    return _core_out(qkv, _core_probs(qkv, _mask_or_zeros(mask, x), heads))


def _forward(x: torch.Tensor, mask: torch.Tensor, w: Params, heads: int,
             scaling: float, eps: float) -> Params:
    """The forward on (rows, W) views, returning what the backward needs.
    ``u`` stays fp32: the int8 c_proj quantizes it, every other product
    rounds it to the compute dtype."""
    cdt = x.dtype
    bsz, seq, width = x.shape
    dot = lambda a, b: _dot(a, b, cdt)  # noqa: E731
    xf = x.reshape(bsz * seq, width).float()
    h1f, xhat1, inv1 = _ln_fwd(xf, w["ln1s"], w["ln1b"], eps)
    qkv = (_product(h1f, w, "wqkv", cdt) + w["bqkv"]).to(cdt)
    probs = _core_probs(qkv.reshape(bsz, seq, 3 * width), mask, heads)
    a = _core_out(qkv.reshape(bsz, seq, 3 * width), probs).reshape(bsz * seq, width)
    a_ao = dot(a, w["out_proj_A"])
    y1 = xf + (dot(a, w["wo"]) + w["bo"] + scaling * dot(a_ao, w["out_proj_B"]))
    h2f, xhat2, inv2 = _ln_fwd(y1, w["ln2s"], w["ln2b"], eps)
    h2 = h2f.to(cdt)
    h2_af = dot(h2, w["c_fc_A"])
    f = _product(h2f, w, "w1", cdt) + w["b1"] + scaling * dot(h2_af, w["c_fc_B"])
    sig = torch.sigmoid(1.702 * f)
    u = f * sig
    u_ap = dot(u, w["c_proj_A"])
    return dict(xhat1=xhat1, inv1=inv1, qkv=qkv, probs=probs, a=a, a_ao=a_ao, y1=y1,
                xhat2=xhat2, inv2=inv2, h2=h2, h2_af=h2_af, f=f, sig=sig, u=u, u_ap=u_ap)


def _block_fwd(x, mask, w, heads, scaling, eps) -> torch.Tensor:
    no_tf32()
    cdt = x.dtype
    t = _forward(x, _mask_or_zeros(mask, x), w, heads, scaling, eps)
    mo = (_product(t["u"], w, "w2", cdt) + w["b2"]
          + scaling * _dot(t["u_ap"], w["c_proj_B"], cdt))
    return (t["y1"] + mo).to(cdt).reshape(x.shape)


def _core_bwd(qkv: torch.Tensor, p: torch.Tensor, da: torch.Tensor, heads: int) -> torch.Tensor:
    """The block's core backward per head from the normalized fp32
    probabilities p (B, H, S, S) of the (B, S, 3W) qkv in the compute dtype
    and the cotangent da of the attention output: dqkv (B, S, 3W) in fp32,
    unrounded (the int8 backward quantizes it from fp32). The function is
    row 9's (``attention.fused_attention_qkv_bwd_ref``), which the card's
    form 0 runs in its place."""
    cdt = qkv.dtype
    bsz, seq, w3 = qkv.shape
    width = w3 // 3
    q, k, v = _split_heads(qkv, heads)  # (B, S, H, D)
    dim = width // heads
    g = da.reshape(bsz, seq, heads, dim).to(cdt).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(cdt).float(), g)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v.float())
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = (ds * dim ** -0.5).to(cdt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return torch.cat([t.reshape(bsz, seq, width) for t in (dq, dk, dv)], dim=-1)


def _block_bwd(x, dy, mask, w, lora, heads, scaling, eps, n_chunks=1):
    """The forward recomputed from x, then the MLP half, LN2, the attention
    half, the per-head core backward and LN1."""
    no_tf32()
    cdt = x.dtype
    bsz, seq, width = x.shape
    rows = bsz * seq
    t = _forward(x, _mask_or_zeros(mask, x), w, heads, scaling, eps)
    dot = lambda a, b: _dot(a, b, cdt)  # noqa: E731
    dy = dy.to(cdt).reshape(rows, width).float()

    # MLP half: y = y1 + u W2 + b2 + s (u Ap) Bp
    t_p = dot(dy, w["c_proj_B"].t())
    du = _product_t(dy, w, "w2", cdt) + scaling * dot(t_p, w["c_proj_A"].t())
    d_ap_a = scaling * dot(t["u"].t(), t_p)
    d_ap_b = scaling * dot(t["u_ap"].t(), dy)
    f, sig = t["f"], t["sig"]
    dfq = du * (sig + 1.702 * f * sig * (1.0 - sig))
    t_f = dot(dfq, w["c_fc_B"].t())
    dh2 = _product_t(dfq, w, "w1", cdt, n_chunks) + scaling * dot(t_f, w["c_fc_A"].t())
    d_af_a = scaling * dot(t["h2"].t(), t_f)
    d_af_b = scaling * dot(t["h2_af"].t(), dfq)
    dy1 = dy + _ln_bwd(dh2, t["xhat2"], t["inv2"], w["ln2s"])

    # attention half: y1 = x + a Wo + bo + s (a Ao) Bo
    t_o = dot(dy1, w["out_proj_B"].t())
    da = dot(dy1, w["wo"].t()) + scaling * dot(t_o, w["out_proj_A"].t())
    d_ao_a = scaling * dot(t["a"].t(), t_o)
    d_ao_b = scaling * dot(t["a_ao"].t(), dy1)

    dqkv = _core_bwd(t["qkv"].reshape(bsz, seq, 3 * width), t["probs"], da, heads)
    dh1 = _product_t(dqkv.reshape(rows, 3 * width), w, "wqkv", cdt)
    dx = dy1 + _ln_bwd(dh1, t["xhat1"], t["inv1"], w["ln1s"])
    dlora = {"out_proj": {"A": d_ao_a, "B": d_ao_b}, "c_fc": {"A": d_af_a, "B": d_af_b},
             "c_proj": {"A": d_ap_a, "B": d_ap_b}}
    dlora = {pt: {ab: g_.to(lora[pt][ab].dtype) for ab, g_ in d.items()}
             for pt, d in dlora.items()}
    return dx.to(cdt).reshape(x.shape), dlora


def text_block_fwd_ref(x: torch.Tensor, mask: Optional[torch.Tensor], bp: Params,
                       lora: Params, *, heads: int, scaling: float,
                       eps: float = 1e-5) -> torch.Tensor:
    """(B, S, W) -> (B, S, W), the TPU kernels' forward op for op."""
    return _block_fwd(x, mask, _operands(bp, lora, x.dtype), heads, scaling, eps)


def text_block_bwd_ref(x: torch.Tensor, dy: torch.Tensor, mask: Optional[torch.Tensor],
                       bp: Params, lora: Params, *, heads: int, scaling: float,
                       eps: float = 1e-5) -> Tuple[torch.Tensor, Params]:
    """(x, dy) -> (dx, dlora), the TPU kernels' backward op for op. dx has
    x's dtype; the six LoRA cotangents are fp32 sums over all B·S rows."""
    return _block_bwd(x, dy, mask, _operands(bp, lora, x.dtype), lora, heads, scaling, eps)


def text_block_fwd_int8_ref(x: torch.Tensor, mask: Optional[torch.Tensor], bp: Params,
                            qw: Params, lora: Params, *, heads: int, scaling: float,
                            n_chunks: int = 1, eps: float = 1e-5) -> torch.Tensor:
    """(B, S, W) -> (B, S, W), ``_int8_block_fwd_stage`` op for op. The
    chunked forward quantizes u over the full hidden axis and sums c_proj in
    int32, so ``n_chunks`` changes nothing here but the order of fp32 sums
    the TPU kernel takes, which this version does not follow."""
    del n_chunks
    return _block_fwd(x, mask, _int8_operands(bp, qw, lora, x.dtype), heads, scaling, eps)


def text_block_bwd_int8_ref(x: torch.Tensor, dy: torch.Tensor, mask: Optional[torch.Tensor],
                            bp: Params, qw: Params, lora: Params, *, heads: int,
                            scaling: float, n_chunks: int = 1,
                            eps: float = 1e-5) -> Tuple[torch.Tensor, Params]:
    """(x, dy) -> (dx, dlora), ``_text_block_bwd_int8_kernel`` op for op;
    with ``n_chunks > 1`` the chunked kernel's per-(row, chunk) quantization
    of ``dfq·s1`` and its chunk-ordered sum into dh2."""
    return _block_bwd(x, dy, mask, _int8_operands(bp, qw, lora, x.dtype), lora, heads, scaling,
                      eps, n_chunks)


def _mask_or_zeros(mask: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    seq = x.shape[1]
    if mask is None:
        return torch.zeros((seq, seq), dtype=torch.float32, device=x.device)
    return mask.to(device=x.device, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Hopper kernels (csrc/text_block.cuh, csrc/text_block_int8.cu), through ctypes
# ---------------------------------------------------------------------------

# The order of the C entry points' weight arguments.
_ORDER = ("ln1s", "ln1b", "ln2s", "ln2b", "wqkv", "bqkv", "wo", "bo", "w1", "b1", "w2", "b2",
          "out_proj_A", "out_proj_B", "c_fc_A", "c_fc_B", "c_proj_A", "c_proj_B")
_ORDER_INT8 = ("ln1s", "ln1b", "ln2s", "ln2b", "wqkv_q", "sqkv", "bqkv", "wo", "bo", "w1_q",
               "s1", "b1", "w2_q", "s2", "b2", "out_proj_A", "out_proj_B", "c_fc_A",
               "c_fc_B", "c_proj_A", "c_proj_B")


def _kernel_operands(name: str, x: torch.Tensor, mask, w: Params, lora: Params,
                     heads: int, mlp_dim: int, order):
    """Checks what the kernels take and returns (args, dims, ranks): the
    weights, vectors and LoRA factors of ``order`` from ``w``, each on x's
    device with its shape (int8 weights as int8), and the (S, S) fp32 mask."""
    bsz, seq, width = x.shape
    if width % heads or width // heads != _HEAD_DIM:
        raise ValueError(f"{name} kernel needs head_dim {_HEAD_DIM}, got W={width}, H={heads}")
    if width % 128 or mlp_dim % 128:
        raise ValueError(f"{name} kernel needs W and M multiples of 128, got {width}, {mlp_dim}")
    if seq > 128:
        raise ValueError(f"{name} kernel takes S <= 128 (one thread per query row), got {seq}")
    dev = x.device
    shapes = {"wqkv": (width, 3 * width), "wo": (width, width), "w1": (width, mlp_dim),
              "w2": (mlp_dim, width), "bqkv": (3 * width,), "b1": (mlp_dim,),
              "sqkv": (3 * width,), "s1": (mlp_dim,),
              **{k: (width,) for k in ("ln1s", "ln1b", "ln2s", "ln2b", "bo", "b2", "s2")}}
    shapes.update({k + "_q": shapes[k] for k in _SCALE})
    for p in POINTS:
        din, dout = {"out_proj": (width, width), "c_fc": (width, mlp_dim),
                     "c_proj": (mlp_dim, width)}[p]
        rank = lora[p]["A"].shape[-1]
        shapes[f"{p}_A"], shapes[f"{p}_B"] = (din, rank), (rank, dout)
    for k in order:
        t = w[k]
        if t.device != dev:
            raise ValueError(f"{name}: {k} lies on {t.device}, x on {dev}")
        if tuple(t.shape) != shapes[k]:
            raise ValueError(f"{name}: {k} must be {shapes[k]}, got {tuple(t.shape)}")
        if k.endswith("_q") and t.dtype != torch.int8:
            raise TypeError(f"{name}: {k} must be int8, got {t.dtype}")
    mask = mask_arg(mask if mask is not None else torch.zeros((seq, seq)), seq, dev)
    ranks = tuple(lora[p]["A"].shape[-1] for p in POINTS)
    return [mask, *(_aligned(w[k]) for k in order)], (bsz, seq, width, heads, mlp_dim), ranks


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned: the GEMMs load 16-byte vectors."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fp_operands(name: str, x: torch.Tensor, mask, bp: Params, lora: Params, heads: int):
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 3:
        raise TypeError(f"{name}: the Hopper kernel takes fp32 or bf16 (B, S, W), "
                        f"got {x.dtype} {tuple(x.shape)}")
    return _kernel_operands(name, x, mask, _operands(bp, lora, x.dtype), lora, heads,
                            bp["mlp"]["w1"].shape[-1], _ORDER)


def _int8_kernel_operands(name: str, x: torch.Tensor, mask, bp: Params, qw: Params,
                          lora: Params, heads: int):
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise TypeError(f"{name}: the Hopper kernel takes bf16 (B, S, W), "
                        f"got {x.dtype} {tuple(x.shape)}")
    return _kernel_operands(name, x, mask, _int8_operands(bp, qw, lora, x.dtype), lora, heads,
                            qw["w1_q"].shape[-1], _ORDER_INT8)


def _scratch(nbytes: int, dev) -> torch.Tensor:
    # Scratch freed on return is reused by the caching allocator only for
    # work queued later on this same stream, so that is safe.
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _grads(dims, ranks, dev):
    """The six fp32 LoRA cotangents in the entry points' order."""
    width, mlp_dim = dims[2], dims[4]
    r_o, r_f, r_p = ranks
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    return [f32(width, r_o), f32(r_o, width), f32(width, r_f), f32(r_f, mlp_dim),
            f32(mlp_dim, r_p), f32(r_p, width)]


def _lora_out(grads, lora: Params) -> Params:
    it = iter(grads)
    return {p: {ab: next(it).to(lora[p][ab].dtype) for ab in ("A", "B")} for p in POINTS}


def _dy_arg(name: str, x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    if tuple(dy.shape) != tuple(x.shape) or dy.device != x.device:
        raise ValueError(f"{name}: dy must be {tuple(x.shape)} on {x.device}, "
                         f"got {tuple(dy.shape)} on {dy.device}")
    return _aligned(dy.to(x.dtype))


def _block_form(name: str, x: torch.Tensor, form: str) -> int:
    """The C entries' code of ``form``: "wgmma" (the route: bf16 and int8 on
    the wgmma stage, the rank-r kernels and the tensor-core cores, S <=
    ``CORE_KEYS``; fp32's SIMT route) or "wmma" (the first design, bf16 and
    int8 only). ValueError on any other, before anything is built or
    launched."""
    code = form_code(name, form)
    if code and x.dtype == torch.float32:
        raise ValueError(f"{name}: fp32 has one route (form 'wgmma'), got {form!r}")
    _core_tile(name, x, form)
    return code


# Keys of the one tile of the form-0 bf16 core forward
# (``csrc/block_core_fwd_mma.cuh``): the text tower's S = 77 in every preset.
CORE_KEYS = 80


def _core_tile(name: str, x: torch.Tensor, form: str) -> None:
    """Raises, before anything is built or launched, where bf16 or int8 form
    0 would run its core forward on more keys than its one tile holds."""
    seq = x.shape[-2]
    if form == "wgmma" and x.dtype != torch.float32 and seq > CORE_KEYS:
        raise ValueError(f"{name} ({form}): the tensor-core core forward takes S <= {CORE_KEYS} "
                         f"(one key tile), got S={seq}")


def block_core_fwd_cuda(qkv: torch.Tensor, mask: Optional[torch.Tensor], heads: int,
                        form: str = "wgmma") -> torch.Tensor:
    """The bf16 text block's core forward alone (B, S, 3W) -> (B, S, W), for
    the card's tests and timing: "wgmma" the tensor-core kernel of form 0
    (S <= ``CORE_KEYS``), "wmma" form 1's ``block_core_fwd_kernel``.
    Uncounted; CUDA bf16 tensors only."""
    name = "block_core_fwd"
    code = form_code(name, form)
    if qkv.dtype != torch.bfloat16 or qkv.dim() != 3:
        raise TypeError(f"{name}: takes bf16 (B, S, 3W), got {qkv.dtype} {tuple(qkv.shape)}")
    bsz, seq, w3 = qkv.shape
    width = w3 // 3
    _core_tile(name, qkv, form)
    if width != heads * _HEAD_DIM:
        raise ValueError(f"{name}: needs head_dim {_HEAD_DIM}, got W={width}, H={heads}")
    lib = load_library()
    qkv = _aligned(qkv)
    mask = mask_arg(mask if mask is not None else torch.zeros((seq, seq)), seq, qkv.device)
    out = torch.empty((bsz, seq, width), dtype=qkv.dtype, device=qkv.device)
    rc = lib.aiic_block_core_fwd(qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), bsz, seq, width,
                                 heads, ctypes.c_float(_qconst(_HEAD_DIM, qkv.dtype)), code,
                                 torch.cuda.current_stream(qkv.device).cuda_stream)
    check(name, rc)
    return out


# The two kinds of rank-r product: a down-projection a·B (B (K, r), or (r,
# K) read transposed) and a LoRA cotangent s·aᵀb over the rows (or its
# transpose).
RANK_KINDS = {"down": 0, "cotangent": 1}


def rank_product_ref(a: torch.Tensor, b: torch.Tensor, kind: str, *, dtype: torch.dtype,
                     trans: bool = False, scaling: float = 1.0) -> torch.Tensor:
    """The plain version of the text block's rank-r products, both operands
    rounded to ``dtype`` with fp32 sums: "down" dtype(a·b) (b (K, r), or
    with ``trans`` (r, K) read as bᵀ); "cotangent" the fp32 scaling·aᵀb for
    a (rows, K), b (rows, r), transposed with ``trans``."""
    no_tf32()
    if kind == "down":
        return _dot(a, b.t() if trans else b, dtype).to(dtype)
    out = scaling * _dot(a.t(), b, dtype)
    return out.t().contiguous() if trans else out


def rank_product_cuda(a: torch.Tensor, b: torch.Tensor, kind: str, *, trans: bool = False,
                      scaling: float = 1.0, form: str = "wgmma") -> torch.Tensor:
    """One rank-r product of the text block alone, on the kernel that form
    0 (and fp32) runs ("wgmma": ``rank_down_kernel``, ``rank_cot_kernel``)
    or form 1's ``narrow_gemm`` ("wmma"), for the card's tests and timing:
    the function of ``rank_product_ref`` with ``dtype`` b's (fp32 or bf16;
    in bf16 a may be fp32, rounded on load). Uncounted; CUDA tensors only."""
    name = "rank_product"
    code = form_code(name, form)
    if kind not in RANK_KINDS:
        raise ValueError(f"{name}: kind must be one of {sorted(RANK_KINDS)}, got {kind!r}")
    fp32 = b.dtype == torch.float32
    if b.dtype not in (torch.float32, torch.bfloat16) or a.dtype not in (torch.float32, b.dtype):
        raise TypeError(f"{name}: b fp32 or bf16 and a fp32 or b's dtype, got {a.dtype}, "
                        f"{b.dtype}")
    if not (a.is_cuda and b.device == a.device):
        raise TypeError(f"{name}: takes CUDA tensors on one device, got {a.device}, {b.device}")
    rows, k = a.shape
    if kind == "down":
        rank = b.shape[0] if trans else b.shape[1]
        if tuple(b.shape) != ((rank, k) if trans else (k, rank)):
            raise ValueError(f"{name}: b must be (K, r) or (r, K) for a (rows, {k})")
        out = torch.empty((rows, rank), dtype=b.dtype, device=a.device)
        depth, wide = k, rows
    else:
        rank = b.shape[1]
        if b.shape[0] != rows:
            raise ValueError(f"{name}: b must be (rows, r) for a ({rows}, K)")
        out = torch.empty((rank, k) if trans else (k, rank), dtype=torch.float32, device=a.device)
        depth, wide = rows, k
    a, b = _aligned(a), _aligned(b)
    part = torch.empty(((depth + 255) // 256) * wide * rank, dtype=torch.float32,
                       device=a.device)
    rc = load_library().aiic_rank_product(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), part.data_ptr(), rows, k, rank,
        RANK_KINDS[kind], int(trans), int(fp32), int(a.dtype == torch.float32 and not fp32),
        ctypes.c_float(scaling), code, torch.cuda.current_stream(a.device).cuda_stream)
    check(name, rc)
    return out


def text_sgemm_cuda(a: torch.Tensor, w: torch.Tensor, *, trans: bool = False) -> torch.Tensor:
    """The fp32 text block's backbone product alone on its SIMT tile
    (``sgemm_kernel``), a @ w (w (K, N)) or a @ wᵀ (``trans``: w (N, K) as a
    weight lies), fp32 sums without TF32, for the card's tests and for
    timing beside cuBLAS. Uncounted; CUDA fp32 tensors, N % 128 == 0, K % 8
    == 0."""
    name = "text_sgemm"
    m, k = a.shape
    n = w.shape[0] if trans else w.shape[1]
    if a.dtype != torch.float32 or w.dtype != torch.float32 or not a.is_cuda:
        raise TypeError(f"{name}: takes CUDA fp32 tensors")
    if (w.shape[1] if trans else w.shape[0]) != k or n % 128 or k % 8:
        raise ValueError(f"{name}: needs w ({'N, K' if trans else 'K, N'}) with N % 128 == 0 "
                         f"and K % 8 == 0, got a {tuple(a.shape)}, w {tuple(w.shape)}")
    a, w = _aligned(a), _aligned(w)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    rc = load_library().aiic_text_sgemm(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                                        int(trans),
                                        torch.cuda.current_stream(a.device).cuda_stream)
    check(name, rc)
    return out


def _text_block_fwd_cuda(x, mask, bp, lora, heads, scaling, eps, form="wgmma"):
    """Row 11 in ``form`` (``_block_form``)."""
    name = "text_block_fwd"
    code = _block_form(name, x, form)
    x = x.contiguous()
    args, dims, ranks = _fp_operands(name, x, mask, bp, lora, heads)
    lib = load_library()
    fp32 = x.dtype == torch.float32
    y = torch.empty_like(x)
    bsz, seq, width, _, mlp_dim = dims
    ws = _scratch(lib.aiic_text_block_workspace(bsz, seq, width, mlp_dim, *ranks, int(fp32), 0),
                  x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.aiic_text_block_fwd(
        x.data_ptr(), *[a.data_ptr() for a in args], y.data_ptr(), ws.data_ptr(), *dims,
        *ranks, ctypes.c_float(scaling), ctypes.c_float(eps),
        ctypes.c_float(_qconst(width // heads, x.dtype)), int(fp32), code, stream)
    check(name, rc)
    return y


def _text_block_bwd_cuda(x, dy, mask, bp, lora, heads, scaling, eps, form="wgmma"):
    """Row 12 in ``form`` (``_block_form``)."""
    name = "text_block_bwd"
    code = _block_form(name, x, form)
    x = x.contiguous()
    dy = _dy_arg(name, x, dy)
    args, dims, ranks = _fp_operands(name, x, mask, bp, lora, heads)
    lib = load_library()
    fp32 = x.dtype == torch.float32
    dx = torch.empty_like(x)
    grads = _grads(dims, ranks, x.device)
    bsz, seq, width, _, mlp_dim = dims
    ws = _scratch(lib.aiic_text_block_workspace(bsz, seq, width, mlp_dim, *ranks, int(fp32), 1),
                  x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.aiic_text_block_bwd(
        x.data_ptr(), dy.data_ptr(), *[a.data_ptr() for a in args], dx.data_ptr(),
        *[g.data_ptr() for g in grads], ws.data_ptr(), *dims, *ranks,
        ctypes.c_float(scaling), ctypes.c_float(eps),
        ctypes.c_float(_qconst(width // heads, x.dtype)), int(fp32), code, stream)
    check(name, rc)
    return dx, _lora_out(grads, lora)


def _kmajor_copies(qw: Params, form: str, forward: bool):
    """The K-major copies w^T of the int8 weights that form 0 reads for the
    forward's products (wqkv, w1; w2 where c_proj runs), made once per
    weight by ``quant.kmajor``; None each for form 1 and the weights not
    read. The backward's cotangent products read the weights as they lie."""
    keys = ("wqkv_q", "w1_q", "w2_q") if forward else ("wqkv_q", "w1_q")
    copies = {k: kmajor(qw[k]) for k in keys} if form == "wgmma" else {}
    return [copies.get(k) for k in ("wqkv_q", "w1_q", "w2_q")]


def _text_block_fwd_int8_cuda(x, mask, bp, qw, lora, heads, scaling, eps, form="wgmma"):
    """Row 13 in ``form``: "wgmma" (the products on the wgmma stage, the
    int8 ones reading the K-major copies) or "wmma" (the first design)."""
    name = "text_block_fwd_int8"
    code = _block_form(name, x, form)
    x = x.contiguous()
    args, dims, ranks = _int8_kernel_operands(name, x, mask, bp, qw, lora, heads)
    kt = _kmajor_copies(qw, form, forward=True)
    lib = load_library()
    y = torch.empty_like(x)
    bsz, seq, width, _, mlp_dim = dims
    ws = _scratch(lib.aiic_text_block_int8_workspace(bsz, seq, width, mlp_dim, *ranks, 1, 0),
                  x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.aiic_text_block_int8_fwd(
        x.data_ptr(), *[a.data_ptr() for a in args], *map(ptr, kt), y.data_ptr(), ws.data_ptr(),
        *dims, *ranks, ctypes.c_float(scaling), ctypes.c_float(eps),
        ctypes.c_float(_qconst(width // heads, x.dtype)), code, stream)
    check(name, rc)
    return y


def _text_block_bwd_int8_cuda(x, dy, mask, bp, qw, lora, heads, scaling, eps, n_chunks,
                              form="wgmma"):
    """Row 14 in ``form``: "wgmma" (the products on the wgmma stage, the
    chunked dh2 product folding its chunk sums, the core backward on row
    9's tensor-core passes storing fp32) or "wmma" (the first design)."""
    name = "text_block_bwd_int8"
    code = _block_form(name, x, form)
    x = x.contiguous()
    dy = _dy_arg(name, x, dy)
    args, dims, ranks = _int8_kernel_operands(name, x, mask, bp, qw, lora, heads)
    mlp_dim = dims[4]
    _card_chunks(name, mlp_dim, n_chunks, form)
    kt = _kmajor_copies(qw, form, forward=False)
    lib = load_library()
    dx = torch.empty_like(x)
    grads = _grads(dims, ranks, x.device)
    bsz, seq, width = dims[:3]
    ws = _scratch(lib.aiic_text_block_int8_workspace(bsz, seq, width, mlp_dim, *ranks,
                                                     n_chunks, 1), x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.aiic_text_block_int8_bwd(
        x.data_ptr(), dy.data_ptr(), *[a.data_ptr() for a in args], *map(ptr, kt),
        dx.data_ptr(), *[g.data_ptr() for g in grads], ws.data_ptr(), *dims, *ranks, n_chunks,
        ctypes.c_float(scaling), ctypes.c_float(eps),
        ctypes.c_float(_qconst(width // heads, x.dtype)), code, stream)
    check(name, rc)
    return dx, _lora_out(grads, lora)


def block_occupancy() -> Dict[str, list]:
    """Blocks per SM of the text block's form-0 kernels, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives them: "bf16"
    [the stage with EpiQkv, EpiY1, EpiFc, EpiDfq, EpiLoRAOut], "int8" [the
    stage with EpiQkv8, EpiFc8, EpiDfq8, EpiDh2, the chunked dh2 fold; the
    two core-backward passes storing fp32], "core_rank" [the tensor-core
    core forward, the bf16 down-projection at 2 and 8 chunks, the bf16 and
    fp32 cotangent products]."""
    lib = load_library()
    bf16, int8, rank = (ctypes.c_int * 5)(), (ctypes.c_int * 7)(), (ctypes.c_int * 5)()
    check("text_block_occupancy", lib.aiic_text_block_occupancy(bf16))
    check("text_block_int8_occupancy", lib.aiic_text_block_int8_occupancy(int8))
    check("text_block_rank_occupancy", lib.aiic_text_block_rank_occupancy(rank))
    return {"bf16": list(bf16), "int8": list(int8), "core_rank": list(rank)}


def int8_matmul_t_cuda(a: torch.Tensor, b: torch.Tensor, ksplit: int = 0,
                       form: str = "wmma") -> torch.Tensor:
    """The int8 product of the int8 backward alone, for the card's tests:
    (K / ksplit, M, N) int32 partial sums of a (M, K) @ b (N, K)ᵀ over depth
    splits of ``ksplit`` (0: one split), on the WMMA tile ("wmma", the first
    design) or the wgmma stage ("wgmma": one split, K a multiple of 128).
    CUDA int8 tensors only."""
    m, k = a.shape
    n = b.shape[0]
    ksplit = ksplit or k
    code = form_code("int8_matmul_t", form)
    if a.dtype != torch.int8 or b.dtype != torch.int8 or not a.is_cuda or b.shape[1] != k:
        raise TypeError("int8_matmul_t_cuda takes CUDA int8 (M, K) and (N, K)")
    if code == 0 and (ksplit != k or k % STAGE_SLICE):
        raise ValueError(f"int8_matmul_t_cuda (wgmma): one split of K a multiple of "
                         f"{STAGE_SLICE}, got K={k}, ksplit={ksplit}")
    out = torch.empty((k // ksplit, m, n), dtype=torch.int32, device=a.device)
    a, b = _aligned(a), _aligned(b)
    rc = load_library().aiic_int8_matmul_t(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                                           ksplit, code,
                                           torch.cuda.current_stream(a.device).cuda_stream)
    check("int8_matmul_t", rc)
    return out


# ---------------------------------------------------------------------------
# Public wrappers (JAX signatures) and the autograd pairings
# ---------------------------------------------------------------------------


@counted
def text_block_fwd(x: torch.Tensor, mask: Optional[torch.Tensor], bp: Params, lora: Params, *,
                   heads: int, scaling: float, eps: float = 1e-5) -> torch.Tensor:
    """(B, S, W) -> (B, S, W): the whole text block forward."""
    if not route("text_block_fwd", x):
        return text_block_fwd_ref(x, mask, bp, lora, heads=heads, scaling=scaling, eps=eps)
    y = _text_block_fwd_cuda(x, mask, bp, lora, heads, scaling, eps)
    text_block_fwd.launches += 1
    return y


@counted
def text_block_bwd(x: torch.Tensor, dy: torch.Tensor, mask: Optional[torch.Tensor], bp: Params,
                   lora: Params, *, heads: int, scaling: float,
                   eps: float = 1e-5) -> Tuple[torch.Tensor, Params]:
    """(B, S, W) x and output cotangent -> (dx, dlora) for one text block."""
    if not route("text_block_bwd", x):
        return text_block_bwd_ref(x, dy, mask, bp, lora, heads=heads, scaling=scaling, eps=eps)
    out = _text_block_bwd_cuda(x, dy, mask, bp, lora, heads, scaling, eps)
    text_block_bwd.launches += 1
    return out


@counted
def text_block_fwd_int8(x: torch.Tensor, mask: Optional[torch.Tensor], bp: Params, qw: Params,
                        lora: Params, *, heads: int, scaling: float, eps: float = 1e-5,
                        force_plan: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(B, S, W) -> (B, S, W): the whole text block forward in int8 serving
    numerics. ``qw``: {wqkv_q, sqkv, w1_q, s1, w2_q, s2} of this layer."""
    n_chunks = _int8_chunks(x, qw["w1_q"].shape[-1], heads, force_plan)
    if not route("text_block_fwd_int8", x):
        return text_block_fwd_int8_ref(x, mask, bp, qw, lora, heads=heads, scaling=scaling,
                                       n_chunks=n_chunks, eps=eps)
    y = _text_block_fwd_int8_cuda(x, mask, bp, qw, lora, heads, scaling, eps)
    text_block_fwd_int8.launches += 1
    return y


@counted
def text_block_bwd_int8(x: torch.Tensor, dy: torch.Tensor, mask: Optional[torch.Tensor],
                        bp: Params, qw: Params, lora: Params, *, heads: int, scaling: float,
                        eps: float = 1e-5, force_plan: Optional[Tuple[int, int]] = None,
                        ) -> Tuple[torch.Tensor, Params]:
    """(B, S, W) x and output cotangent -> (dx, dlora) for one text block in
    int8 serving numerics, under the straight-through estimator."""
    n_chunks = _int8_chunks(x, qw["w1_q"].shape[-1], heads, force_plan)
    if not route("text_block_bwd_int8", x):
        return text_block_bwd_int8_ref(x, dy, mask, bp, qw, lora, heads=heads, scaling=scaling,
                                       n_chunks=n_chunks, eps=eps)
    out = _text_block_bwd_int8_cuda(x, dy, mask, bp, qw, lora, heads, scaling, eps, n_chunks)
    text_block_bwd_int8.launches += 1
    return out


def _lora_tree(factors) -> Params:
    it = iter(factors)
    return {p: {ab: next(it) for ab in ("A", "B")} for p in POINTS}


def _factors(lora: Params):
    return [lora[p][ab] for p in POINTS for ab in ("A", "B")]


class TextBlockLoRA(torch.autograd.Function):
    """One training text block whose backward is ``text_block_bwd``:
    differentiable in x and the six LoRA factors (all three attach points
    required); the frozen backbone and the mask get no gradient."""

    @staticmethod
    def forward(ctx, x, bp, mask, heads, scaling, *factors):
        ctx.bp, ctx.heads, ctx.scaling = bp, heads, scaling
        ctx.save_for_backward(x, mask, *factors)
        return text_block_fwd(x, mask, bp, _lora_tree(factors), heads=heads, scaling=scaling)

    @staticmethod
    def backward(ctx, dy):
        x, mask, *factors = ctx.saved_tensors
        dx, dl = text_block_bwd(x, dy, mask, ctx.bp, _lora_tree(factors), heads=ctx.heads,
                                scaling=ctx.scaling)
        return (dx, None, None, None, None, *_factors(dl))


def text_block_lora(x: torch.Tensor, bp: Params, lora: Params, mask: torch.Tensor, heads: int,
                    scaling: float) -> torch.Tensor:
    """The port of ``aiic_tpu.ops.block_grad.text_block_lora``."""
    return TextBlockLoRA.apply(x, bp, mask, heads, scaling, *_factors(lora))


class TextBlockLoRAInt8(torch.autograd.Function):
    """One training text block in int8 serving numerics whose backward is
    ``text_block_bwd_int8``: differentiable in x and the six LoRA factors;
    the int8 weights, their scales, the rest of the backbone and the mask
    get no gradient."""

    @staticmethod
    def forward(ctx, x, bp, qw, mask, heads, scaling, *factors):
        ctx.bp, ctx.qw, ctx.heads, ctx.scaling = bp, qw, heads, scaling
        ctx.save_for_backward(x, mask, *factors)
        return text_block_fwd_int8(x, mask, bp, qw, _lora_tree(factors), heads=heads,
                                   scaling=scaling)

    @staticmethod
    def backward(ctx, dy):
        x, mask, *factors = ctx.saved_tensors
        dx, dl = text_block_bwd_int8(x, dy, mask, ctx.bp, ctx.qw, _lora_tree(factors),
                                     heads=ctx.heads, scaling=ctx.scaling)
        return (dx, None, None, None, None, None, *_factors(dl))


def text_block_lora_int8(x: torch.Tensor, bp: Params, qw: Params, lora: Params,
                         mask: torch.Tensor, heads: int, scaling: float) -> torch.Tensor:
    """The port of ``aiic_tpu.ops.block_grad.text_block_lora_int8``."""
    return TextBlockLoRAInt8.apply(x, bp, qw, mask, heads, scaling, *_factors(lora))
