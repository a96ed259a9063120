"""Variants of the int8 half-block kernels (rows 1-2): the port's twins of
the candidate and ablation kernels of ``tools/kernel_experiments{,2,3,4,5,7}.py``.

Each TPU function of those tools has three faces here, as every kernel of
the port has:

- a plain PyTorch version (``int8_attn_nomax_ref``, ``mlp_var_ref``,
  ``attn_var2_ref``, ``mlp_var3_ref``, ``attn_var4_ref``, ``attn_var5_ref``,
  ``attn_var7_ref``) that follows the tool's kernel body line for line, with
  its rounding sites: ``(x, lp, variant)`` for bf16 x (B, S, W) and one
  layer's parameters ``lp`` (``layer_params``); an unknown variant raises
  ``ValueError``;
- a Hopper kernel: one C entry per half (``csrc/attn_variants.cu``,
  ``csrc/mlp_variants.cu``) that takes the variant's id and its form and
  runs its launch sequence. Form 0 (``"wgmma"``, the route) is rows 1-2's
  current design: every product on the ``wgmma`` + TMA GEMM stage, the int8
  ones reading the K-major weight copies that ``layer_params`` carries, and
  every attention core on a tensor-core variant core
  (``csrc/attn_variants_wgmma.cu``, ``csrc/mlp_variants_wgmma.cu``). Form 1
  (``"wmma"``) is the first design (common.cuh's WMMA GEMM and a scalar
  core), kept for the side-by-side time and reached, uncounted, through
  ``_attn_cuda`` / ``_mlp_cuda(..., form="wmma")``;
- a ``@counted`` wrapper of the same name without ``_ref``: the plain
  version for a CPU tensor, form 0 of the kernel (one counted launch per
  call) for a CUDA tensor.

What the variants compute (the tools' names; "base" is the tools' body: LN1
in fp32, per-row int8 quantization dividing by the scale, the int8 QKV
product dequantized as ``bf16(acc·hscale·sqkv + bqkv)``, the core per
(image, head) in fp32, then the out-projection and ``bf16(xf + out)``):

- attention (``ATTN_VARIANTS``): ``nomax`` (natural exp with no clamp and no
  max, p divided by its sum before p·V, int8 out-projection); ``v1``-``v4``
  (the clamp 70 or 80, exp or exp2, the denominator folded after p·V or
  divided before it; ``v4`` one activation scale per image pair);
  ``noln``, ``nosm``, ``nocore``, ``maconly``, ``qobf16`` (ablations on the
  exp2 fold core with the int8 out-projection); ``gbatch``, ``hstack``,
  ``hg`` (row 1's math without the 1e-38 guard; on the card three block
  schedules of the core); ``coreqk``, ``corepv``, ``coreboth`` (int8 Q·Kᵀ
  and/or p·V with no clamp, bf16 out-projection);
- MLP (``MLP_VARIANTS``): ``static`` (per-tensor activation scales 6/127 and
  30/127, multiplied by their reciprocal); ``nogelu``, ``noln``, ``noq``,
  ``maconly``, ``macbf16`` (ablations); ``q2bf16``, ``gelu2``, ``gelubf16``
  (the second product in bf16, the exp2 gelu, the gelu rounded to bf16 op
  by op). The MLP's gelu is ``y·sigmoid(1.702y)`` as ``jax.nn.sigmoid``
  expands it, ``1/(1 + exp(-z))``, unless the variant names another.

The ablations are numerically wrong on purpose: they remove a pass to
measure its cost. Variants 16a-e (``attn_var*``, ``mlp_var3``) run the TPU
grid of two images and raise ``ValueError`` for an odd batch (the TPU grid
``B // 2`` leaves the last image unwritten); ``int8_attn_nomax`` and
``mlp_var`` take any batch.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from aiic_tpu_torch.ops._build import (
    check, counted, f32_vector, form_code, load_library, ptr, route, weight,
)
from aiic_tpu_torch.ops.attention import LOG2E, _qconst, no_tf32
from aiic_tpu_torch.ops.quant import _check_inputs, kmajor, quantize_weight

EPS = 1e-5
LN2 = 0.6931471805599453
HEAD_DIM = 64
KEY_TILE = 64  # the tensor-core variant core's key tile
STATIC_H_SCALE = 6.0 / 127.0   # kernel_experiments.py: "plausible post-LN range"
STATIC_Y_SCALE = 30.0 / 127.0


@dataclasses.dataclass(frozen=True)
class Core:
    """The attention core of a variant: exp2 (Q pre-scaled by the bf16
    ``scale·log2 e``) or exp (scores scaled after the dot); the clamp (None:
    none); the denominator folded after p·V or p divided before it; softmax
    (False: p = s, denominator 1); int8 Q·Kᵀ and/or p·V."""

    exp2: bool
    clamp: Optional[float]
    fold: bool
    softmax: bool = True
    qk8: bool = False
    pv8: bool = False


@dataclasses.dataclass(frozen=True)
class AttnVariant:
    vid: int                    # the C entry's variant id
    core: Optional[Core]        # None: no core (nocore, maconly)
    quant: str = "row"          # "row" | "tile" (v4) | "const3" (maconly)
    ln: bool = True
    out: str = "int8"           # "int8" | "bf16" | "mac" out-projection
    sched: str = "head"         # the card's core schedule (16d)


@dataclasses.dataclass(frozen=True)
class MlpVariant:
    vid: int
    quant1: str = "row"         # "row" | "static" | "bf16" | "const3" | "none" (x itself)
    ln: bool = True
    gelu: str = "sigmoid"       # "sigmoid" | "exp2" | "bf16" | "none"
    quant2: str = "row"         # "row" | "static" | "bf16" | "clip"
    bias: bool = True           # b1 and b2 (not in macbf16)


_V3 = Core(exp2=True, clamp=70.0 * LOG2E, fold=True)
ATTN_VARIANTS: Dict[str, AttnVariant] = {
    "nomax": AttnVariant(0, Core(exp2=False, clamp=None, fold=False)),
    "v1": AttnVariant(1, Core(exp2=False, clamp=70.0, fold=True)),
    "v2": AttnVariant(2, Core(exp2=True, clamp=80.0 * LOG2E, fold=False)),
    "v3": AttnVariant(3, _V3),
    "v4": AttnVariant(4, Core(exp2=False, clamp=80.0, fold=False), quant="tile"),
    "noln": AttnVariant(5, _V3, ln=False),
    "nosm": AttnVariant(6, Core(exp2=True, clamp=None, fold=True, softmax=False)),
    "nocore": AttnVariant(7, None),
    "maconly": AttnVariant(8, None, quant="const3", ln=False, out="mac"),
    "qobf16": AttnVariant(9, _V3, out="bf16"),
    "gbatch": AttnVariant(10, _V3, out="bf16", sched="gbatch"),
    "hstack": AttnVariant(11, _V3, out="bf16", sched="hstack"),
    "hg": AttnVariant(12, _V3, out="bf16", sched="hg"),
    "coreqk": AttnVariant(13, Core(exp2=True, clamp=None, fold=True, qk8=True), out="bf16"),
    "corepv": AttnVariant(14, Core(exp2=True, clamp=None, fold=True, pv8=True), out="bf16"),
    "coreboth": AttnVariant(15, Core(exp2=True, clamp=None, fold=True, qk8=True, pv8=True),
                            out="bf16"),
}
MLP_VARIANTS: Dict[str, MlpVariant] = {
    "static": MlpVariant(0, quant1="static", quant2="static"),
    "nogelu": MlpVariant(1, gelu="none"),
    "noln": MlpVariant(2, ln=False),
    "noq": MlpVariant(3, quant1="bf16", quant2="bf16"),
    "maconly": MlpVariant(4, quant1="const3", ln=False, gelu="none", quant2="clip", bias=False),
    "macbf16": MlpVariant(5, quant1="none", ln=False, gelu="none", quant2="bf16", bias=False),
    "q2bf16": MlpVariant(6, quant2="bf16"),
    "gelu2": MlpVariant(7, gelu="exp2"),
    "gelubf16": MlpVariant(8, gelu="bf16"),
}
# The variants each TPU function runs, by wrapper.
WRAPPER_VARIANTS: Dict[str, Tuple[str, ...]] = {
    "int8_attn_nomax": ("nomax",),
    "mlp_var": ("static",),
    "attn_var2": ("v1", "v2", "v3", "v4"),
    "mlp_var3": ("nogelu", "noln", "noq", "maconly", "macbf16", "q2bf16", "gelu2", "gelubf16"),
    "attn_var4": ("noln", "nosm", "nocore", "maconly", "qobf16"),
    "attn_var5": ("gbatch", "hstack", "hg"),
    "attn_var7": ("coreqk", "corepv", "coreboth"),
}
# kernel_experiments.py runs G=1 for an odd batch; the others a grid of B // 2.
_ANY_BATCH = ("int8_attn_nomax", "mlp_var")


def layer_params(blocks: Dict, heads: int) -> List[Dict[str, object]]:
    """One flat dict per layer from a ``quantize_model`` tower's stacked
    ``blocks``: the LN vectors, ``wqkv_q, sqkv, bqkv``, the unquantized
    ``wo`` with ``bo``, ``w1_q, s1, b1, w2_q, s2, b2``, the unquantized
    ``w1``/``w2`` (the bf16 variants' weights), ``heads``, and the int8
    out-projection ``wo_q, so = quantize_weight(wo)`` that the historical
    variants keep (the serving tree's out-projection is bf16); and the
    K-major copies ``wqkv_t, wo_t, w1_t, w2_t`` (w^T of each int8 weight,
    made once by ``quant.kmajor`` as for the serving tree), which form 0's
    int8 products read: 8-bit ``wgmma`` takes a K-major B only."""
    out = []
    for i in range(blocks["attn"]["wqkv"].shape[0]):
        wo_q, so = quantize_weight(blocks["attn"]["wo"][i])
        wqkv_q, w1_q, w2_q = (blocks["attn_q"]["wqkv_q"][i], blocks["mlp_q"]["w1_q"][i],
                              blocks["mlp_q"]["w2_q"][i])
        out.append({
            "ln1_s": blocks["ln1"]["scale"][i], "ln1_b": blocks["ln1"]["bias"][i],
            "wqkv_q": wqkv_q, "sqkv": blocks["attn_q"]["sqkv"][i],
            "bqkv": blocks["attn"]["bqkv"][i], "wo": blocks["attn"]["wo"][i],
            "bo": blocks["attn"]["bo"][i], "wo_q": wo_q, "so": so,
            "ln2_s": blocks["ln2"]["scale"][i], "ln2_b": blocks["ln2"]["bias"][i],
            "w1_q": w1_q, "s1": blocks["mlp_q"]["s1"][i],
            "b1": blocks["mlp"]["b1"][i], "w2_q": w2_q,
            "s2": blocks["mlp_q"]["s2"][i], "b2": blocks["mlp"]["b2"][i],
            "w1": blocks["mlp"]["w1"][i], "w2": blocks["mlp"]["w2"][i], "heads": heads,
            "wqkv_t": kmajor(wqkv_q), "wo_t": kmajor(wo_q), "w1_t": kmajor(w1_q),
            "w2_t": kmajor(w2_q),
        })
    return out


def _spec(wrapper: str, variant: str, bsz: int):
    if variant not in WRAPPER_VARIANTS[wrapper]:
        raise ValueError(f"{wrapper}: unknown variant {variant!r}; it runs "
                         f"{WRAPPER_VARIANTS[wrapper]}")
    if bsz % 2 and wrapper not in _ANY_BATCH:
        raise ValueError(f"{wrapper}: the TPU grid holds two images a step; an odd batch "
                         f"({bsz}) would leave its last image unwritten")
    table = MLP_VARIANTS if wrapper.startswith("mlp") else ATTN_VARIANTS
    return table[variant]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _c127(device) -> torch.Tensor:
    """127 as a tensor: PyTorch's CUDA division by a Python scalar multiplies
    by its rounded reciprocal, the kernels and the TPU bodies divide."""
    return torch.tensor(127.0, device=device)


def _row_quant(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_row_quant`` of the TPU bodies along the last axis: scale =
    max(amax, 1e-6) / 127, q = clip(round(h / scale), ±127)."""
    scale = torch.clamp(h.abs().amax(dim=-1, keepdim=True), min=1e-6) / _c127(h.device)
    return torch.clamp(torch.round(h / scale), -127, 127), scale


def _block_sum(t: torch.Tensor) -> torch.Tensor:
    """Row sums of fp32 (rows, n) in the order of the kernels' row pass
    (common.cuh ``block_reduce``): 256 threads each add their strided
    elements to 0 in turn, each warp of 32 folds its lanes by xor butterfly
    (16, 8, 4, 2, 1), then warp 0 folds the 8 warp sums the same way; (rows, 1)."""
    rows, n = t.shape
    k = -(-n // 256)
    part = torch.nn.functional.pad(t, (0, k * 256 - n)).reshape(rows, k, 256)
    acc = torch.zeros((rows, 256), dtype=torch.float32, device=t.device)
    for i in range(k):
        acc = acc + part[:, i]
    lanes = torch.arange(32, device=t.device)
    v = acc.reshape(rows, 8, 32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    v = torch.nn.functional.pad(v[..., 0], (0, 24))
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v[:, :1]


def _ln(xf: torch.Tensor, scale, bias) -> torch.Tensor:
    """LayerNorm in fp32, eps 1e-5, as the tool bodies write it
    ((x - mean) · rsqrt(var + eps) · s + b), with the statistics summed in
    the kernels' order and rsqrt as 1 / sqrt: the int8 quantizer downstream
    turns a last-bit difference of h into a whole quantum, and the ablations
    without a softmax (nosm) carry that quantum to every row of the image."""
    w = torch.tensor(float(xf.shape[-1]), device=xf.device)
    mean = _block_sum(xf) / w
    d = xf - mean
    var = _block_sum(d * d) / w
    rstd = 1.0 / torch.sqrt(var + EPS)
    return d * rstd * scale.reshape(1, -1).float() + bias.reshape(1, -1).float()


def _recip_quant(h: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(h · (1 / scale)), ±127): the static and tile quantizers."""
    return torch.clamp(torch.round(h * (1.0 / scale)), -127, 127)


def _imm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of integer-valued tensors (float64 holds every
    partial sum: |sum| <= 3072·127² < 2^53), as int32."""
    return (a.double() @ b.double()).to(torch.int32)


def _fmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16-valued operands, exact products summed in fp32 (TF32 off)."""
    return a.float() @ b.float()


def _vec(t, n: int) -> torch.Tensor:
    return t.reshape(1, n).float()


def _sigmoid_gelu(y: torch.Tensor) -> torch.Tensor:
    """y · sigmoid(1.702 y), sigmoid as XLA expands it: 1 / (1 + exp(-z))."""
    z = torch.tensor(1.702, dtype=torch.float32, device=y.device) * y
    return y * (1.0 / (1.0 + torch.exp(-z)))


def _exp2_gelu(y: torch.Tensor) -> torch.Tensor:
    c = torch.tensor(-1.702 * LOG2E, dtype=torch.float32, device=y.device)
    return y * (1.0 / (1.0 + torch.exp2(c * y)))


def _bf16_gelu(y: torch.Tensor) -> torch.Tensor:
    """kernel_experiments3.py's ``gelubf16``: every op in bf16, and
    ``jnp.exp2`` as JAX defines it, exp(x · ln 2) with ln 2 and the product
    in the operand's type (bf16 0.69140625)."""
    bf = dict(dtype=torch.bfloat16, device=y.device)
    yb = y.to(torch.bfloat16)
    t = torch.tensor(-1.702 * LOG2E, **bf) * yb
    p = torch.exp(t * torch.tensor(LN2, **bf))
    one = torch.tensor(1.0, **bf)
    return (yb * (one / (one + p))).float()


_GELU = {"sigmoid": _sigmoid_gelu, "exp2": _exp2_gelu, "bf16": _bf16_gelu, "none": lambda y: y}


def _core_ref(qkv: torch.Tensor, heads: int, c: Core) -> torch.Tensor:
    """The per-(image, head) core of the tool bodies on (B, S, 3W) bf16 qkv,
    every head at once; fp32 (B·S, W)."""
    bsz, seq, w3 = qkv.shape
    width = w3 // 3
    dim = width // heads
    scale = dim ** -0.5
    t = qkv.reshape(bsz, seq, 3, heads, dim).permute(2, 0, 3, 1, 4)  # (3, B, H, S, D)
    q, k, v = t[0], t[1], t[2]
    if c.qk8:
        qq, qs = _row_quant(q.float())
        kq, ks = _row_quant(k.float())
        acc = _imm(qq, kq.transpose(-1, -2)).float()
        s = acc * (qs * torch.tensor(scale * LOG2E, dtype=torch.float32,
                                     device=qkv.device)) * ks.transpose(-1, -2)
    elif c.exp2:
        qc = q * torch.tensor(scale * LOG2E, dtype=q.dtype, device=q.device)
        s = _fmm(qc, k.transpose(-1, -2))
    else:
        s = _fmm(q, k.transpose(-1, -2)) * scale
    if not c.softmax:
        o = _fmm(s.to(v.dtype), v)  # p = s; o · (1 / 1)
    else:
        if c.clamp is not None:
            s = torch.minimum(s, torch.tensor(c.clamp, dtype=torch.float32, device=s.device))
        p = torch.exp2(s) if c.exp2 else torch.exp(s)
        denom = p.sum(dim=-1, keepdim=True)
        if not c.fold:
            o = _fmm((p / denom).to(v.dtype), v)
        else:
            if c.pv8:
                pq, ps = _row_quant(p)
                vf = v.float()
                vs = vf.abs().amax(dim=-2, keepdim=True) / _c127(vf.device) + 1e-12
                vq = torch.round(vf / vs)
                o = _imm(pq, vq).float() * ps * vs
            else:
                o = _fmm(p.to(v.dtype), v)
            o = o * (1.0 / denom)
    return o.permute(0, 2, 1, 3).reshape(bsz * seq, width)


def _attn_ref(wrapper: str, x: torch.Tensor, lp: Dict, variant: str) -> torch.Tensor:
    no_tf32()
    bsz, seq, width = x.shape
    spec = _spec(wrapper, variant, bsz)
    rows = bsz * seq
    xf = x.float().reshape(rows, width)
    if spec.quant == "const3":  # maconly: constant operands, two int8 products
        acc = _imm(torch.full((rows, width), 3.0, device=x.device), lp["wqkv_q"])
        aq = torch.clamp(acc[:, :width], -127, 127)
        return (xf + _imm(aq, lp["wo_q"]).float()).to(x.dtype).reshape(bsz, seq, width)
    h = _ln(xf, lp["ln1_s"], lp["ln1_b"]) if spec.ln else xf
    sqkv, bqkv = _vec(lp["sqkv"], 3 * width), _vec(lp["bqkv"], 3 * width)
    if spec.quant == "tile":  # v4: one scale over each image pair's (2S, W) tile
        ht = h.reshape(bsz // 2, 2 * seq, width)
        hscale = torch.clamp(ht.abs().amax(dim=(1, 2), keepdim=True), min=1e-6) / _c127(x.device)
        acc = _imm(_recip_quant(ht, hscale).reshape(rows, width), lp["wqkv_q"]).float()
        acc = acc.reshape(bsz // 2, 2 * seq, 3 * width)
        qkv = (acc * (hscale * sqkv) + bqkv).reshape(rows, 3 * width)
    else:
        hq, hscale = _row_quant(h)
        qkv = _imm(hq, lp["wqkv_q"]).float() * hscale * sqkv + bqkv
    qkv = qkv.to(x.dtype)
    if spec.core is None:  # nocore
        attn = qkv[:, :width].float()
    else:
        attn = _core_ref(qkv.reshape(bsz, seq, 3 * width), lp["heads"], spec.core)
    if spec.out == "int8":
        aq, ascale = _row_quant(attn)
        out = _imm(aq, lp["wo_q"]).float() * ascale * _vec(lp["so"], width) + _vec(lp["bo"], width)
    else:
        out = _fmm(attn.to(x.dtype), lp["wo"].to(x.dtype)) + _vec(lp["bo"], width)
    return (xf + out).to(x.dtype).reshape(bsz, seq, width)


def _mlp_ref(wrapper: str, x: torch.Tensor, lp: Dict, variant: str) -> torch.Tensor:
    no_tf32()
    bsz, seq, width = x.shape
    spec = _spec(wrapper, variant, bsz)
    mlp_dim = lp["w1_q"].shape[-1]
    rows = bsz * seq
    xf = x.float().reshape(rows, width)
    b1, b2 = _vec(lp["b1"], mlp_dim), _vec(lp["b2"], width)
    s1, s2 = _vec(lp["s1"], mlp_dim), _vec(lp["s2"], width)
    if spec.quant1 == "const3":  # maconly
        yq = torch.clamp(_imm(torch.full((rows, width), 3.0, device=x.device), lp["w1_q"]),
                         -127, 127)
        return (xf + _imm(yq, lp["w2_q"]).float()).to(x.dtype).reshape(bsz, seq, width)
    if spec.quant1 == "none":  # macbf16: x itself, no LN, no bias
        y = _fmm(x.reshape(rows, width), lp["w1"].to(x.dtype))
    else:
        h = _ln(xf, lp["ln2_s"], lp["ln2_b"]) if spec.ln else xf
        if spec.quant1 == "bf16":
            y = _fmm(h.to(x.dtype), lp["w1"].to(x.dtype)) + b1
        elif spec.quant1 == "static":
            hs = torch.tensor(STATIC_H_SCALE, dtype=torch.float32, device=x.device)
            y = _imm(_recip_quant(h, hs), lp["w1_q"]).float() * hs * s1 + b1
        else:
            hq, hscale = _row_quant(h)
            y = _imm(hq, lp["w1_q"]).float() * hscale * s1 + b1
    y = _GELU[spec.gelu](y)
    if spec.quant2 == "bf16":
        out = _fmm(y.to(x.dtype), lp["w2"].to(x.dtype))
        if spec.bias:
            out = out + b2
    elif spec.quant2 == "static":
        ys = torch.tensor(STATIC_Y_SCALE, dtype=torch.float32, device=x.device)
        out = _imm(_recip_quant(y, ys), lp["w2_q"]).float() * ys * s2 + b2
    else:
        yq, yscale = _row_quant(y)
        out = _imm(yq, lp["w2_q"]).float() * yscale * s2 + b2
    return (xf + out).to(x.dtype).reshape(bsz, seq, width)


def int8_attn_nomax_ref(x, lp, variant="nomax"):
    """kernel_experiments.py ``int8_attn_nomax`` (``_nomax_kernel``)."""
    return _attn_ref("int8_attn_nomax", x, lp, variant)


def mlp_var_ref(x, lp, variant="static"):
    """kernel_experiments.py ``mlp_var(static_scale=True)`` (``_mlp_kernel_var``)."""
    return _mlp_ref("mlp_var", x, lp, variant)


def attn_var2_ref(x, lp, variant):
    """kernel_experiments2.py ``attn_var`` (``make_kernel``)."""
    return _attn_ref("attn_var2", x, lp, variant)


def mlp_var3_ref(x, lp, variant):
    """kernel_experiments3.py ``mlp_var`` (``make_kernel``)."""
    return _mlp_ref("mlp_var3", x, lp, variant)


def attn_var4_ref(x, lp, variant):
    """kernel_experiments4.py ``attn_var`` (``make_kernel``)."""
    return _attn_ref("attn_var4", x, lp, variant)


def attn_var5_ref(x, lp, variant):
    """kernel_experiments5.py ``attn_var`` (``make_kernel``): row 1's math
    without the 1e-38 guard; the TPU's batched head dots do not enter it."""
    return _attn_ref("attn_var5", x, lp, variant)


def attn_var7_ref(x, lp, variant):
    """kernel_experiments7.py ``attn_var`` (``make_kernel``, ``core_int8``)."""
    return _attn_ref("attn_var7", x, lp, variant)


# ---------------------------------------------------------------------------
# The kernels (csrc/attn_variants.cu, csrc/mlp_variants.cu)
# ---------------------------------------------------------------------------


def _attn_cuda(wrapper: str, x: torch.Tensor, lp: Dict, variant: str,
               form: str = "wgmma") -> torch.Tensor:
    """The attention variant on the card in ``form``: "wgmma" (the route:
    the stage and the tensor-core variant core) or "wmma" (the first
    design). Any other form raises before the library loads."""
    code = form_code(wrapper, form)
    bsz, seq, width = x.shape
    spec = _spec(wrapper, variant, bsz)
    weights = [("wqkv_q", (width, 3 * width)), ("wo_q", (width, width))]
    if form == "wgmma":  # the K-major copies that layer_params makes
        weights += [("wqkv_t", (3 * width, width)), ("wo_t", (width, width))]
    _check_inputs(wrapper, x, *[(lp[k], shape) for k, shape in weights])
    heads = lp["heads"]
    if width != heads * HEAD_DIM or width % 128:
        raise ValueError(f"{wrapper} kernel needs head_dim 64 and W % 128 == 0, got W={width}, "
                         f"H={heads}")
    kt = [lp["wqkv_t"], lp["wo_t"]] if form == "wgmma" else [None, None]
    dev, rows = x.device, bsz * seq
    args = [x.contiguous(), f32_vector(lp["ln1_s"], width, dev), f32_vector(lp["ln1_b"], width, dev),
            lp["wqkv_q"], kt[0],
            f32_vector(lp["sqkv"], 3 * width, dev), f32_vector(lp["bqkv"], 3 * width, dev),
            lp["wo_q"], kt[1], f32_vector(lp["so"], width, dev),
            weight(wrapper, lp["wo"], (width, width), torch.bfloat16, dev),
            f32_vector(lp["bo"], width, dev), torch.empty_like(x),
            torch.empty((rows, width), dtype=torch.int8, device=dev),       # hq
            torch.empty((rows,), dtype=torch.float32, device=dev),          # hs
            torch.empty((rows,), dtype=torch.float32, device=dev),          # row amax (v4)
            torch.empty((rows, 3 * width), dtype=torch.bfloat16, device=dev),  # qkv
            torch.empty((rows, width), dtype=torch.float32, device=dev),    # attn (f32 or bf16)
            torch.empty((rows, width), dtype=torch.int8, device=dev),       # aq
            torch.empty((rows,), dtype=torch.float32, device=dev)]          # as
    # Form 0's int8 cores (coreqk, corepv, coreboth) quantize K and V once per
    # (image, head) in a pre-pass: K and V^T in int8, their row and channel
    # scales, each (image, head) padded to s_pad keys.
    int8_core = form == "wgmma" and spec.core is not None and (spec.core.qk8 or spec.core.pv8)
    s_pad = -(-seq // KEY_TILE) * KEY_TILE
    args += ([torch.empty((2 * bsz * heads * s_pad * HEAD_DIM,), dtype=torch.int8, device=dev),
              torch.empty((bsz * heads * (s_pad + HEAD_DIM),), dtype=torch.float32, device=dev)]
             if int8_core else [None, None])
    rc = load_library().aiic_attn_variant(
        spec.vid, *[ptr(a) for a in args], bsz, seq, width, heads, ctypes.c_float(EPS),
        ctypes.c_float(_qconst(HEAD_DIM, torch.bfloat16)), code,
        torch.cuda.current_stream(dev).cuda_stream)
    check(wrapper, rc)
    return args[12]


def _mlp_cuda(wrapper: str, x: torch.Tensor, lp: Dict, variant: str,
              form: str = "wgmma") -> torch.Tensor:
    """The MLP variant on the card in ``form``: "wgmma" (the route: every
    product on the stage) or "wmma" (the first design). Any other form
    raises before the library loads."""
    code = form_code(wrapper, form)
    bsz, seq, width = x.shape
    spec = _spec(wrapper, variant, bsz)
    mlp_dim = lp["w1_q"].shape[-1]
    weights = [("w1_q", (width, mlp_dim)), ("w2_q", (mlp_dim, width))]
    if form == "wgmma":
        weights += [("w1_t", (mlp_dim, width)), ("w2_t", (width, mlp_dim))]
    _check_inputs(wrapper, x, *[(lp[k], shape) for k, shape in weights])
    if width % 128 or mlp_dim % 128:
        raise ValueError(f"{wrapper} kernel needs W and 4W multiples of 128, got {width}, {mlp_dim}")
    kt = [lp["w1_t"], lp["w2_t"]] if form == "wgmma" else [None, None]
    dev, rows = x.device, bsz * seq
    args = [x.contiguous(), f32_vector(lp["ln2_s"], width, dev), f32_vector(lp["ln2_b"], width, dev),
            lp["w1_q"], kt[0],
            f32_vector(lp["s1"], mlp_dim, dev), f32_vector(lp["b1"], mlp_dim, dev),
            lp["w2_q"], kt[1],
            f32_vector(lp["s2"], width, dev), f32_vector(lp["b2"], width, dev),
            weight(wrapper, lp["w1"], (width, mlp_dim), torch.bfloat16, dev),
            weight(wrapper, lp["w2"], (mlp_dim, width), torch.bfloat16, dev), torch.empty_like(x),
            torch.empty((rows, width), dtype=torch.int8, device=dev),          # hq
            torch.empty((rows, width), dtype=torch.bfloat16, device=dev),      # hb
            torch.empty((rows,), dtype=torch.float32, device=dev),             # hs
            torch.empty((rows, mlp_dim), dtype=torch.float32, device=dev),     # y
            torch.empty((rows, mlp_dim), dtype=torch.bfloat16, device=dev),    # yb
            torch.empty((rows, mlp_dim), dtype=torch.int8, device=dev),        # yq
            torch.empty((rows,), dtype=torch.float32, device=dev)]             # ys
    rc = load_library().aiic_mlp_variant(
        spec.vid, *[ptr(a) for a in args], rows, width, mlp_dim, ctypes.c_float(EPS), code,
        torch.cuda.current_stream(dev).cuda_stream)
    check(wrapper, rc)
    return args[13]


def _run(fn, wrapper, plain, kernel, x, lp, variant):
    if not route(wrapper, x):
        return plain(wrapper, x, lp, variant)
    out = kernel(wrapper, x, lp, variant)
    fn.launches += 1
    return out


@counted
def int8_attn_nomax(x, lp, variant="nomax"):
    return _run(int8_attn_nomax, "int8_attn_nomax", _attn_ref, _attn_cuda, x, lp, variant)


@counted
def mlp_var(x, lp, variant="static"):
    return _run(mlp_var, "mlp_var", _mlp_ref, _mlp_cuda, x, lp, variant)


@counted
def attn_var2(x, lp, variant):
    return _run(attn_var2, "attn_var2", _attn_ref, _attn_cuda, x, lp, variant)


@counted
def mlp_var3(x, lp, variant):
    return _run(mlp_var3, "mlp_var3", _mlp_ref, _mlp_cuda, x, lp, variant)


@counted
def attn_var4(x, lp, variant):
    return _run(attn_var4, "attn_var4", _attn_ref, _attn_cuda, x, lp, variant)


@counted
def attn_var5(x, lp, variant):
    return _run(attn_var5, "attn_var5", _attn_ref, _attn_cuda, x, lp, variant)


@counted
def attn_var7(x, lp, variant):
    return _run(attn_var7, "attn_var7", _attn_ref, _attn_cuda, x, lp, variant)


WRAPPERS = {name: globals()[name] for name in WRAPPER_VARIANTS}
PLAIN = {name: globals()[name + "_ref"] for name in WRAPPER_VARIANTS}


# ---------------------------------------------------------------------------
# Work counts, for the bound
# ---------------------------------------------------------------------------


def reads(wrapper: str, variant: str) -> Tuple[str, ...]:
    """The keys of ``lp`` whose tensors the variant's kernel reads."""
    if wrapper.startswith("mlp"):
        s = MLP_VARIANTS[variant]
        keys = ("ln2_s", "ln2_b") if s.ln else ()
        keys += {"row": ("w1_q", "s1"), "static": ("w1_q", "s1"), "bf16": ("w1",),
                 "const3": ("w1_q",), "none": ("w1",)}[s.quant1]
        keys += {"row": ("w2_q", "s2"), "static": ("w2_q", "s2"), "bf16": ("w2",),
                 "clip": ("w2_q",)}[s.quant2]
        return keys + (("b1", "b2") if s.bias else ())
    s = ATTN_VARIANTS[variant]
    keys = ("ln1_s", "ln1_b") if s.ln else ()
    keys += ("wqkv_q",) if s.quant == "const3" else ("wqkv_q", "sqkv", "bqkv")
    return keys + {"int8": ("wo_q", "so", "bo"), "bf16": ("wo", "bo"), "mac": ("wo_q",)}[s.out]


def ops(wrapper: str, variant: str, bsz: int, seq: int, width: int,
        mlp_dim: int = 0) -> Dict[str, int]:
    """The products' operations by operand type (2 per multiply-add); the
    core's Q·Kᵀ and p·V count as the type of their operands, whatever units
    run them. Passes the variant drops count nothing."""
    rows = bsz * seq
    n: Dict[str, int] = {"int8": 0, "bf16": 0}
    if wrapper.startswith("mlp"):
        s = MLP_VARIANTS[variant]
        n["bf16" if s.quant1 in ("bf16", "none") else "int8"] += 2 * rows * width * mlp_dim
        n["bf16" if s.quant2 == "bf16" else "int8"] += 2 * rows * mlp_dim * width
        return {k: v for k, v in n.items() if v}
    s = ATTN_VARIANTS[variant]
    n["int8"] += 2 * rows * width * 3 * width
    half = 2 * bsz * seq * seq * width  # one of Q·Kᵀ, p·V over all heads
    if s.core is not None:
        n["int8" if s.core.qk8 else "bf16"] += half
        n["int8" if s.core.pv8 else "bf16"] += half
    n["bf16" if s.out == "bf16" else "int8"] += 2 * rows * width * width
    return {k: v for k, v in n.items() if v}
