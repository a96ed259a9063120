"""int8 serving quantization and the two int8 half-block kernels.

Port of ``aiic_tpu.ops.quant``. Weights quantize per output channel
offline (``quantize_weight``); activations quantize per row inside the
kernels (symmetric, amax/127, ``_row_quant``); integer products accumulate
in int32 and everything after the dequant runs in fp32.

The MLP half runs the plan of the JAX package's ``_mlp_plan`` (copied here
with the other VMEM planners, each budget a module constant): "full" is row
2's kernel, "chunked" row 3's (``int8_ln_mlp_chunked``: the gelu output
quantized per (row, chunk), which changes the numerics, so the chunk count
follows the planner), "xla" the plain version on the tensor's device. The
attention half runs row 1's kernel where the TPU kernel fits, else
``_int8_attn_large_s`` (the int8 projection, the packed core or the
head-grouped one on weights permuted head-major once, a bf16 out-projection)
or, where no head fits, ``_int8_attn_rows_xla``. ``int8_block`` is the whole
block (row 4) on ``_block_plan``'s plan; ``models.clip.block`` takes it on
the JAX package's auto rule.

Each half-block has three faces here:

- a **plain version** (``int8_ln_qkv_attention_ref``, ``int8_ln_mlp_ref``):
  the JAX package's reference math in PyTorch ops, on any device. Its
  integer products run as float64 matmuls — exact below 2^53, while fp32 is
  not exact at K=3072 (127·127·3072 > 2^24) and ``torch.matmul`` has no int8
  path on the card.
- a **Hopper kernel** in ``aiic_tpu_torch/csrc`` (CUDA C++ for sm_90a, built
  by ``ops._build``), launched by ``_int8_ln_qkv_attention_cuda`` /
  ``_int8_ln_mlp_cuda`` / ``_int8_block_cuda``: the products of rows 1-4 on
  the ``wgmma`` + TMA GEMM stage (``csrc/wgmma_serving_gemm.cuh``, reachable
  alone as ``gemm_stage``; row 3's c_proj with the chunk sums folded into
  its mainloop), row 1's core on the tensor-core core of rows 6-8. Their
  WMMA forms (the first design) stay reachable as ``form="wmma"``,
  uncounted, for timing and the bit-for-bit check of the int8 stages.
- a **public wrapper** with the JAX signature. It takes the plain version
  only for tensors on the CPU; for a CUDA tensor it launches the kernel or
  raises. ``wrapper.launches`` counts kernel launches and nothing else
  (``ops._build.counted``; ``ops._build.reset_launch_counts`` zeroes every
  kernel's).
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Tuple

import torch

from aiic_tpu_torch.ops._build import (
    bf16_activation, check, counted, f32_vector, form_code, load_library, mask_arg, ptr, route,
    weight,
)
from aiic_tpu_torch.ops import attention as attention_ops
from aiic_tpu_torch.ops.attention import (
    LOG2E, _fallback_chunk, _ln_fp32, _mm, _qconst, fits_some_group, fused_attention_qkv_ref,
    no_tf32,
)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(in, out) fp weight -> (int8 weight, fp32 per-output-channel scale (1, out))."""
    wf = w.float()
    amax = wf.abs().amax(dim=0, keepdim=True)
    # An all-zero column quantizes to zeros, not 0/0.
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def _row_quant(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (rows, d) -> (int8, fp32 per-row scale (rows, 1)); round half to even."""
    amax = h.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(h / scale), -127, 127).to(torch.int8)
    return q, scale


def _gelu_exp2(y: torch.Tensor) -> torch.Tensor:
    """quick_gelu via exp2: sigmoid(1.702 y) = 1 / (1 + 2^(-1.702·log2(e)·y))."""
    c = torch.tensor(-1.702 * LOG2E, dtype=torch.float32, device=y.device)
    return y * (1.0 / (1.0 + torch.exp2(c * y)))


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product through float64."""
    return (a.double() @ b.double()).to(torch.int32)


def kmajor(w: torch.Tensor) -> torch.Tensor:
    """The K-major copy w^T (out, in) of an (in, out) weight, contiguous: the
    B operand of the int8 ``wgmma`` stage, which takes a K-major B only.
    Computed once per weight and cached as ``attention.headmajor_columns``
    caches: on the tensor that owns w's storage (the stacked weight of all
    layers, for a layer's view), keyed by the view's offset, shape, strides
    and version, so that the parameter tree keeps its keys and an in-place
    change of the weight makes a new copy. An inference tensor (a weight
    made under ``torch.inference_mode``, as the large-S path's head-major
    copy is) keeps no version: its key has none."""
    owner = w if w._base is None else w._base
    cache = owner.__dict__.setdefault("_aiic_kmajor", {})
    key = (w.storage_offset(), tuple(w.shape), tuple(w.stride()),
           None if w.is_inference() else w._version)
    hit = cache.get(key)
    if hit is None:
        hit = cache[key] = w.t().contiguous()
    return hit


# The epilogues of the GEMM stage (gemm_stage) and their C codes; the bf16
# ones (row 1's out-projection, rows 5 and 10's QKV and c_fc, the text
# block's cotangent product through a weight read transposed) take bf16
# operands, the others int8. ``ops._build.FORMS`` names the forms of the
# stage and of rows 1-5 and 10-14 on the card.
STAGE_EPILOGUES = {"qkv": 0, "gelu": 1, "residual": 2, "out_proj": 3, "chunk_residual": 4,
                   "bias": 5, "bias_gelu": 6, "chunk_rowscale": 7, "dot_t": 8}
BF16_EPILOGUES = ("out_proj", "bias", "bias_gelu", "dot_t")
# The epilogues that fold the sums of K's chunks into the stage's mainloop
# (the wgmma form only), and those that store fp32.
FOLD_EPILOGUES = ("chunk_residual", "chunk_rowscale")
F32_EPILOGUES = ("gelu", "chunk_rowscale", "dot_t")
# What each epilogue reads besides a and w: row_scale, col_scale, bias, x.
_STAGE_READS = {"qkv": "rcb", "gelu": "rcb", "residual": "rcbx", "out_proj": "bx",
                "chunk_residual": "rcbx", "bias": "b", "bias_gelu": "b", "chunk_rowscale": "r",
                "dot_t": ""}
# The depth of one K-slice of the wgmma stage in int8 (128 B): row 3's chunk
# of the hidden axis must be a whole number of them.
STAGE_SLICE = 128


def gemm_stage_ref(a, w, epilogue: str, *, row_scale=None, col_scale=None, bias=None,
                   x=None, n_chunks: int = 1) -> torch.Tensor:
    """One product of rows 1-5, 10 or 11-14 with its epilogue, as their
    plain versions compute it: a (rows, K) . w (K, N), int8 exact in int32
    (qkv, gelu, residual, chunk_residual, chunk_rowscale) or bf16 with fp32
    sums (out_proj, bias, bias_gelu, dot_t), then qkv: bf16(acc·rs·cs + b);
    gelu: gelu_exp2(acc·rs·cs + b) in fp32; residual: bf16(x + (acc·rs·cs +
    b)); out_proj: bf16(x + (acc + b)); bias (row 5's QKV): bf16(acc + b);
    bias_gelu (row 10's c_fc): bf16(gelu_exp2(acc + b)), fp32 through the
    gelu; chunk_residual (row 3's c_proj, K in ``n_chunks`` chunks, rs (rows,
    C)): the fp32 sum seeded with x, each chunk's acc_c·rs[:, c]·cs added in
    order, b last, then bf16; chunk_rowscale (row 14's chunked dh2 product
    without its LoRA term, rs (rows, C)): the fp32 sum from 0, each chunk's
    acc_c·rs[:, c] added in order, fp32 out; dot_t (the text block's
    cotangent products g·Wᵀ): w given (N, K) as the weight lies, fp32 a·wᵀ."""
    no_tf32()
    if epilogue == "dot_t":
        return a.float() @ w.float().t()
    n = w.shape[-1]
    if epilogue == "chunk_rowscale":
        chunk = w.shape[0] // n_chunks
        rs = row_scale.reshape(-1, n_chunks).float()
        total = torch.zeros((a.shape[0], n), dtype=torch.float32, device=a.device)
        for c in range(n_chunks):
            sl = slice(c * chunk, (c + 1) * chunk)
            total = total + _int_matmul(a[:, sl], w[sl]).float() * rs[:, c:c + 1]
        return total
    b = bias.reshape(1, n).float()
    if epilogue in BF16_EPILOGUES:
        v = a.float() @ w.float() + b
        if epilogue == "out_proj":
            return (x.float() + v).to(torch.bfloat16)
        return (_gelu_exp2(v) if epilogue == "bias_gelu" else v).to(torch.bfloat16)
    if epilogue == "chunk_residual":
        chunk = w.shape[0] // n_chunks
        rs = row_scale.reshape(-1, n_chunks).float()
        cs = col_scale.reshape(1, n).float()
        total = x.float()
        for c in range(n_chunks):
            sl = slice(c * chunk, (c + 1) * chunk)
            total = total + _int_matmul(a[:, sl], w[sl]).float() * rs[:, c:c + 1] * cs
        return (total + b).to(torch.bfloat16)
    v = (_int_matmul(a, w).float() * row_scale.reshape(-1, 1).float()
         * col_scale.reshape(1, n).float() + b)
    if epilogue == "qkv":
        return v.to(torch.bfloat16)
    if epilogue == "gelu":
        return _gelu_exp2(v)
    return (x.float() + v).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# The JAX package's VMEM planners (aiic_tpu/ops/quant.py), copied as routing:
# the chunk count C of "chunked" plans sets the gelu output's quantization
# granularity, and the plans pick the branch (kernel, large S, plain).
# ---------------------------------------------------------------------------

_VMEM_BUDGET = 14 * 1024 * 1024


def _mlp_vmem_bytes(group: int, seq: int, width: int, mlp_dim: int, itemsize: int) -> int:
    rows = group * seq
    return (2 * rows * width * itemsize + 2 * width * mlp_dim + rows * width * 4
            + rows * mlp_dim * 4 + rows * mlp_dim)


def _mlp_chunk_vmem_bytes(group: int, seq: int, width: int, mlp_dim: int, n_chunks: int,
                          itemsize: int) -> int:
    rows = group * seq
    chunk = mlp_dim // n_chunks
    return (2 * rows * width * itemsize + 2 * width * chunk + rows * width * 4
            + rows * width * 4 + rows * width + rows * chunk * 4 + rows * chunk)


def _mlp_plan(bsz: int, seq: int, width: int, mlp_dim: int,
              itemsize: int) -> Tuple[str, int, int]:
    """("full", G, 1), ("chunked", G, C) or ("xla", 1, 1), as the JAX package
    plans the int8 MLP: the largest image group first, then the fewest
    chunks. Note the parity rule: an even batch tries G=2 first, so ViT-L/14
    runs C=4 at an even bucket and C=2 at one image."""
    group = 2 if bsz % 2 == 0 else 1
    while group > 1 and _mlp_vmem_bytes(group, seq, width, mlp_dim, itemsize) > _VMEM_BUDGET:
        group //= 2
    if _mlp_vmem_bytes(group, seq, width, mlp_dim, itemsize) <= _VMEM_BUDGET:
        return ("full", group, 1)
    for g in (2, 1):
        if bsz % g:
            continue
        c = 2
        while mlp_dim % c == 0 and mlp_dim // c >= 128:
            if _mlp_chunk_vmem_bytes(g, seq, width, mlp_dim, c, itemsize) <= _VMEM_BUDGET:
                return ("chunked", g, c)
            c *= 2
    return ("xla", 1, 1)


def _attn_vmem_bytes(group: int, seq: int, width: int, itemsize: int) -> int:
    rows = group * seq
    return (2 * rows * width * itemsize + 3 * width * width + width * width * itemsize
            + rows * width * 4 + rows * 3 * width * 4 + rows * 3 * width * itemsize
            + 2 * seq * seq * 4 + rows * width * 4)


def _block_vmem_bytes(group: int, seq: int, width: int, mlp_dim: int, itemsize: int) -> int:
    rows = group * seq
    resident = (2 * rows * width * itemsize + 3 * width * width + width * width * itemsize
                + 2 * width * mlp_dim + rows * width * 4)
    attn_stage = (rows * 3 * width * 4 + rows * 3 * width * itemsize + 2 * seq * seq * 4
                  + rows * width * 4)
    mlp_stage = rows * width * 4 + rows * mlp_dim * 4 + rows * mlp_dim
    return resident + max(attn_stage, mlp_stage)


def _block_chunk_vmem_bytes(group: int, seq: int, width: int, mlp_dim: int, n_chunks: int,
                            itemsize: int) -> int:
    rows = group * seq
    chunk = mlp_dim // n_chunks
    resident = (2 * rows * width * itemsize + 3 * width * width + width * width * itemsize
                + 2 * width * chunk + rows * width * 4 + rows * width)
    attn_stage = (rows * 3 * width * 4 + rows * 3 * width * itemsize + 2 * seq * seq * 4
                  + rows * width * 4)
    chunk_stage = rows * chunk * 4 + rows * chunk
    return resident + max(attn_stage, chunk_stage)


def _block_plan(bsz: int, seq: int, width: int, mlp_dim: int, itemsize: int):
    """The whole int8 block's plan: ("full", G, 1), ("chunked", G, C) or None."""
    for g in (2, 1):
        if bsz % g == 0 and _block_vmem_bytes(g, seq, width, mlp_dim, itemsize) <= _VMEM_BUDGET:
            return ("full", g, 1)
    for g in (2, 1):
        if bsz % g:
            continue
        c = 2
        while mlp_dim % c == 0 and mlp_dim // c >= 128:
            if _block_chunk_vmem_bytes(g, seq, width, mlp_dim, c, itemsize) <= _VMEM_BUDGET:
                return ("chunked", g, c)
            c *= 2
    return None


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def int8_ln_mlp_ref(x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2,
                    *, eps: float = 1e-5, n_chunks: int = 1) -> torch.Tensor:
    """(B, S, W) -> x + int8-MLP(LN(x)); ``_int8_mlp_rows(n_chunks=C)``. LN
    and its quantization once; each chunk c computes gelu(hq @ w1[:, c])
    quantized per (row, chunk) and its c_proj partial. One chunk: partial +
    b2, then the residual; several: the fp32 sum starts from the residual,
    adds the partials in chunk order and b2 last."""
    no_tf32()
    bsz, seq, width = x.shape
    mlp_dim = w1_q.shape[-1]
    chunk = mlp_dim // n_chunks
    xf = x.float().reshape(bsz * seq, width)
    h = _ln_fp32(xf, ln_scale.reshape(1, width), ln_bias.reshape(1, width), eps)
    hq, hscale = _row_quant(h)
    s1, b1 = s1.reshape(1, mlp_dim).float(), b1.reshape(1, mlp_dim).float()
    s2, b2 = s2.reshape(1, width).float(), b2.reshape(1, width).float()

    def part(c):
        sl = slice(c * chunk, (c + 1) * chunk)
        y = _gelu_exp2(_int_matmul(hq, w1_q[:, sl]).float() * hscale * s1[:, sl] + b1[:, sl])
        yq, yscale = _row_quant(y)
        return _int_matmul(yq, w2_q[sl]).float() * yscale * s2

    if n_chunks == 1:
        total = xf + (part(0) + b2)
    else:
        total = xf
        for c in range(n_chunks):
            total = total + part(c)
        total = total + b2
    return total.to(x.dtype).reshape(bsz, seq, width)


def _int8_qkv_ref(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, eps):
    """LN -> per-row int8 quantization -> int8 QKV product, dequantized as
    ``acc·hscale·sqkv + bqkv`` and rounded to x's dtype: (B, S, 3W)."""
    bsz, seq, width = x.shape
    h = _ln_fp32(x.float(), ln_scale.reshape(1, width), ln_bias.reshape(1, width), eps)
    hq, hscale = _row_quant(h.reshape(bsz * seq, width))
    acc = _int_matmul(hq, wqkv_q)
    qkv = (acc.float() * hscale * sqkv.reshape(1, 3 * width).float()
           + bqkv.reshape(1, 3 * width).float())
    return qkv.to(x.dtype).reshape(bsz, seq, 3 * width)


def int8_ln_qkv_attention_ref(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wo, bo,
                              mask=None, *, heads: int,
                              eps: float = 1e-5) -> torch.Tensor:
    """(B, S, W) -> x + OutProj(Attn(QKV_int8(LN(x)))) with the kernel's
    numerics (``_int8_attn_rows_xla_body``): bf16 qkv after the dequant,
    Q scaled by the bf16-rounded ``scale·log2 e``, clamped no-max exp2
    softmax with the denominator folded past p·V, bf16 output projection."""
    no_tf32()
    bsz, seq, width = x.shape
    qkv = _int8_qkv_ref(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, eps)
    attn = fused_attention_qkv_ref(qkv, mask, heads)

    out = attn.float().reshape(bsz * seq, width) @ wo.to(x.dtype).float()
    out = out + bo.reshape(1, width).float()
    return (x.float() + out.reshape(bsz, seq, width)).to(x.dtype)


def int8_block_ref(x, ln1_scale, ln1_bias, wqkv_q, sqkv, bqkv, wo, bo, mask, ln2_scale,
                   ln2_bias, w1_q, s1, b1, w2_q, s2, b2, *, heads: int, eps: float = 1e-5,
                   plan=("full", 1, 1)) -> torch.Tensor:
    """The whole int8 block (``_int8_block_kernel`` / ``_int8_block_chunk_kernel``):
    the attention half, its output in x's dtype, then the MLP half on it
    with one chunk ("full") or the plan's C ("chunked": the fp32 sum seeded
    with y1f, the chunks' partials in order, b2 last)."""
    y1 = int8_ln_qkv_attention_ref(x, ln1_scale, ln1_bias, wqkv_q, sqkv, bqkv, wo, bo, mask,
                                   heads=heads, eps=eps)
    return int8_ln_mlp_ref(y1, ln2_scale, ln2_bias, w1_q, s1, b1, w2_q, s2, b2, eps=eps,
                           n_chunks=plan[2] if plan[0] == "chunked" else 1)


def _int8_attn_rows_xla(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wo, bo, mask, *,
                        heads: int, eps: float) -> torch.Tensor:
    """``int8_ln_qkv_attention_ref`` in batch chunks whose fp32 scores stay
    under ``_FALLBACK_PROBS_BUDGET``: where not even one head's core fits,
    the JAX package runs this in XLA, the port in plain PyTorch on the
    tensor's device."""
    chunk = _fallback_chunk(x.shape[0], heads, x.shape[1])
    return torch.cat([int8_ln_qkv_attention_ref(x[i:i + chunk], ln_scale, ln_bias, wqkv_q, sqkv,
                                                bqkv, wo, bo, mask, heads=heads, eps=eps)
                      for i in range(0, x.shape[0], chunk)])


# ---------------------------------------------------------------------------
# Hopper kernels (aiic_tpu_torch/csrc), launched through ctypes
# ---------------------------------------------------------------------------


def _check_inputs(name: str, x: torch.Tensor, *weights) -> None:
    """x must be bf16 (B, S, W); each (weight, shape) contiguous int8 of
    that shape on x's device — the kernel reads them through raw pointers."""
    bf16_activation(name, x)
    for w, shape in weights:
        if (w.dtype != torch.int8 or not w.is_contiguous() or w.device != x.device
                or tuple(w.shape) != shape):
            raise TypeError(f"{name}: int8 weight must be contiguous int8 {shape} on {x.device}, "
                            f"got {w.dtype} {tuple(w.shape)} on {w.device}")


def _mlp_args(name, x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2, n_chunks, form):
    """The MLP half's checked arguments and scratch (rows = B·S): x, LN
    vectors, w1_q, s1, b1, w2_q, s2, b2, out, hq, hs, y, yq, ys (rows·C).
    Raises, before anything is launched, on a chunk of the hidden axis that
    the form cannot take: the wgmma stage folds whole 128-B K-slices
    (``STAGE_SLICE``), the WMMA form 32-deep tiles."""
    bsz, seq, width = x.shape
    mlp_dim = w1_q.shape[-1]
    _check_inputs(name, x, (w1_q, (width, mlp_dim)), (w2_q, (mlp_dim, width)))
    depth = STAGE_SLICE if form == "wgmma" else 32
    if width % 128 or mlp_dim % 128 or mlp_dim % n_chunks or (mlp_dim // n_chunks) % depth:
        raise ValueError(f"{name} kernel ({form}) needs W and 4W multiples of 128 and the chunk "
                         f"4W/C a multiple of {depth}, got W={width}, 4W={mlp_dim}, C={n_chunks}")
    rows, dev = bsz * seq, x.device
    return [x.contiguous(), f32_vector(ln_scale, width, dev), f32_vector(ln_bias, width, dev),
            w1_q, f32_vector(s1, mlp_dim, dev), f32_vector(b1, mlp_dim, dev), w2_q,
            f32_vector(s2, width, dev), f32_vector(b2, width, dev), torch.empty_like(x),
            torch.empty((rows, width), dtype=torch.int8, device=dev),
            torch.empty((rows,), dtype=torch.float32, device=dev),
            torch.empty((rows, mlp_dim), dtype=torch.float32, device=dev),
            torch.empty((rows, mlp_dim), dtype=torch.int8, device=dev),
            torch.empty((rows * n_chunks,), dtype=torch.float32, device=dev)]


def _int8_ln_mlp_cuda(x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2, eps, n_chunks=1,
                      form="wgmma"):
    """Row 2 (``n_chunks`` 1) or row 3 (``n_chunks`` > 1) in ``form``:
    "wgmma" (the route: the products on the wgmma stage, reading the
    K-major copies; row 3's c_proj folding the chunk sums) or "wmma" (the
    first design; row 3's c_proj split by chunk into fp32 slices and a sum
    pass)."""
    bsz, seq, width = x.shape
    rows, mlp_dim = bsz * seq, w1_q.shape[-1]
    name = "int8_ln_mlp" if n_chunks == 1 else "int8_ln_mlp_chunked"
    args = _mlp_args(name, x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2, n_chunks, form)
    lib = load_library()
    # The scratch tensors are freed when this returns, before the kernels
    # run: PyTorch's caching allocator reuses their memory only for work
    # queued later on this same (current) stream, so that is safe.
    stream = torch.cuda.current_stream(x.device).cuda_stream
    kt = [kmajor(args[3]), kmajor(args[6])] if form == "wgmma" else [None, None]
    p = [ptr(a) for a in args]
    p = [*p[:4], ptr(kt[0]), *p[4:7], ptr(kt[1]), *p[7:]]
    eps = ctypes.c_float(eps)
    if n_chunks == 1:
        rc = lib.aiic_int8_ln_mlp(*p, rows, width, mlp_dim, eps, form_code(name, form), stream)
    else:
        part = (torch.empty((n_chunks, rows, width), dtype=torch.float32, device=x.device)
                if form == "wmma" else None)
        rc = lib.aiic_int8_ln_mlp_chunked(*p, ptr(part), rows, width, mlp_dim, n_chunks, eps,
                                          form_code(name, form), stream)
    check(name, rc)
    return args[9]


def _attn_args(name, x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wo, bo, mask, heads):
    """The attention half's checked arguments: x, LN vectors, wqkv_q, sqkv,
    bqkv, wo (bf16), bo, mask."""
    bsz, seq, width = x.shape
    _check_inputs(name, x, (wqkv_q, (width, 3 * width)))
    if width % heads or width // heads != 64 or width % 128:
        raise ValueError(f"{name} kernel needs head_dim 64 and W % 128 == 0, "
                         f"got W={width}, H={heads}")
    dev = x.device
    return [x.contiguous(), f32_vector(ln_scale, width, dev), f32_vector(ln_bias, width, dev),
            wqkv_q, f32_vector(sqkv, 3 * width, dev), f32_vector(bqkv, 3 * width, dev),
            weight(name, wo, (width, width), torch.bfloat16, dev), f32_vector(bo, width, dev),
            mask_arg(mask, seq, dev)]


def _int8_ln_qkv_attention_cuda(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wo,
                                bo, mask, heads, eps, form="wgmma"):
    """Row 1 in ``form``: "wgmma" (the route: the QKV product and the
    out-projection on the wgmma stage, the tensor-core core) or "wmma" (the
    first design: WMMA products, the scalar core)."""
    bsz, seq, width = x.shape
    args = _attn_args("int8_ln_qkv_attention", x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wo, bo,
                      mask, heads)
    lib = load_library()
    rows, dev = bsz * seq, x.device
    out = torch.empty_like(x)
    hq = torch.empty((rows, width), dtype=torch.int8, device=dev)
    hs = torch.empty((rows,), dtype=torch.float32, device=dev)
    qkv = torch.empty((rows, 3 * width), dtype=torch.bfloat16, device=dev)
    attn = torch.empty((rows, width), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = [ptr(a) for a in args + [out, hq, hs, qkv, attn]]
    wqkv_t = kmajor(wqkv_q) if form == "wgmma" else None
    rc = lib.aiic_int8_ln_qkv_attention(
        *p[:4], ptr(wqkv_t), *p[4:], bsz, seq, width, heads, ctypes.c_float(eps),
        ctypes.c_float(_qconst(width // heads, torch.bfloat16)),
        form_code("int8_ln_qkv_attention", form), stream)
    check("int8_ln_qkv_attention", rc)
    return out


def _int8_qkv(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, eps, form="wgmma"):
    """The int8 QKV projection of the large-S path, (B, S, 3W) in x's dtype:
    on the card row 1's first two launches (LN row quantizer, the int8
    product on the wgmma stage with the dequant epilogue; ``form="wmma"``
    the WMMA product), on the CPU ``_int8_qkv_ref``. JAX runs this stage in
    XLA, so it is not a TPU kernel: the route counts one launch of the GEMM
    stage (``gemm_stage``) and none of its own."""
    if not route("int8_qkv", x):
        return _int8_qkv_ref(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, eps)
    bsz, seq, width = x.shape
    _check_inputs("int8_qkv", x, (wqkv_q, (width, 3 * width)))
    if width % 128:
        raise ValueError(f"int8_qkv kernel needs W % 128 == 0, got {width}")
    lib = load_library()
    rows, dev = bsz * seq, x.device
    qkv = torch.empty((bsz, seq, 3 * width), dtype=torch.bfloat16, device=dev)
    hq = torch.empty((rows, width), dtype=torch.int8, device=dev)
    hs = torch.empty((rows,), dtype=torch.float32, device=dev)
    args = [x.contiguous(), f32_vector(ln_scale, width, dev), f32_vector(ln_bias, width, dev),
            wqkv_q, kmajor(wqkv_q) if form == "wgmma" else None,
            f32_vector(sqkv, 3 * width, dev), f32_vector(bqkv, 3 * width, dev), qkv, hq, hs]
    rc = lib.aiic_int8_ln_qkv(*[ptr(a) for a in args], rows, width, ctypes.c_float(eps),
                              form_code("int8_qkv", form),
                              torch.cuda.current_stream(dev).cuda_stream)
    check("int8_qkv", rc)
    if form == "wgmma":
        gemm_stage.launches += 1
    return qkv


def stage_occupancy() -> list:
    """Blocks of the GEMM stage resident on one SM: [int8 (c_fc's), bf16
    (the out-projection's), folded int8 (row 3's c_proj), bf16 bias (row
    5's QKV), bf16 bias_gelu (row 10's c_fc)], as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives them."""
    blocks = (ctypes.c_int * 5)()
    check("gemm_stage_occupancy", load_library().aiic_gemm_stage_occupancy(blocks))
    return list(blocks)


def _gemm_stage_cuda(a, w, epilogue, row_scale, col_scale, bias, x, form="wgmma", n_chunks=1):
    """The stage alone on the card (``aiic_gemm_stage``): the checked
    arguments, the output ((rows, N) fp32 for ``F32_EPILOGUES``, bf16
    otherwise), the launch. The folds run in the wgmma form only, on K in
    ``n_chunks`` chunks of whole 128-B slices; dot_t takes w (N, K), read as
    the K-major B it is in the wgmma form and transposed in the WMMA one."""
    name = "gemm_stage"
    int8 = epilogue not in BF16_EPILOGUES
    dtype = torch.int8 if int8 else torch.bfloat16
    if a.dim() != 2 or w.dim() != 2 or a.dtype != dtype or w.dtype != dtype:
        raise TypeError(f"{name}[{epilogue}]: takes 2-D {dtype} a and w, got {a.dtype} "
                        f"{tuple(a.shape)} and {w.dtype} {tuple(w.shape)}")
    rows, k = a.shape
    n_axis = 0 if epilogue == "dot_t" else 1  # w is (N, K) for dot_t, else (K, N)
    n, dev = w.shape[n_axis], a.device
    depth = STAGE_SLICE if int8 else 64
    if w.shape[1 - n_axis] != k or n % 128 or k % (depth * n_chunks) or w.device != dev:
        raise ValueError(f"{name}[{epilogue}]: needs w ({'N, K' if n_axis == 0 else 'K, N'}) "
                         f"on {dev} with N % 128 == 0 and K (each of its {n_chunks} chunks) a "
                         f"multiple of {depth}, got a {tuple(a.shape)}, w {tuple(w.shape)} on "
                         f"{w.device}")
    chunked = epilogue in FOLD_EPILOGUES
    if n_chunks < 1 or (n_chunks > 1 and not chunked) or (chunked and form != "wgmma"):
        raise ValueError(f"{name}[{epilogue}]: chunks of K go with {FOLD_EPILOGUES} in the "
                         f"wgmma form alone, got n_chunks={n_chunks}, form {form!r}")
    code = form_code(f"{name}[{epilogue}]", form)
    reads, given = _STAGE_READS[epilogue], dict(r=row_scale, c=col_scale, b=bias, x=x)
    missing = [r for r in reads if given[r] is None]
    if missing:
        names = dict(r="row_scale", c="col_scale", b="bias", x="the residual x")
        raise ValueError(f"{name}[{epilogue}]: needs {', '.join(names[m] for m in missing)}")
    a, w = a.contiguous(), w.contiguous()
    wk = kmajor(w) if int8 and form == "wgmma" else w
    rs = f32_vector(row_scale, rows * n_chunks, dev) if "r" in reads else None
    cs = f32_vector(col_scale, n, dev) if "c" in reads else None
    b = f32_vector(bias, n, dev) if "b" in reads else None
    xr = x.to(torch.bfloat16).reshape(rows, n).contiguous() if "x" in reads else None
    out = torch.empty((rows, n), device=dev, dtype=torch.float32
                      if epilogue in F32_EPILOGUES else torch.bfloat16)
    rc = load_library().aiic_gemm_stage(
        ptr(a), ptr(wk), ptr(rs), ptr(cs), ptr(b), ptr(xr), ptr(out),
        rows, n, k, n_chunks, STAGE_EPILOGUES[epilogue], code,
        torch.cuda.current_stream(dev).cuda_stream)
    check(name, rc)
    return out


def _int8_block_cuda(x, attn_w, mlp_w, heads, eps, n_chunks, form="wgmma"):
    """Row 4 in ``form``: "wgmma" (the route: row 1's form 0, then row 2's
    or row 3's on the wgmma stage, reading the K-major copies) or "wmma"
    (the first design: the WMMA rows in turn)."""
    name = "int8_block"
    bsz, seq, width = x.shape
    a = _attn_args(name, x, *attn_w, heads)
    m = _mlp_args(name, x, *mlp_w, n_chunks, form)
    lib = load_library()
    rows, dev = bsz * seq, x.device
    mlp_dim = m[3].shape[-1]
    y1 = torch.empty_like(a[0])
    qkv = torch.empty((rows, 3 * width), dtype=torch.bfloat16, device=dev)
    attn = torch.empty((rows, width), dtype=torch.bfloat16, device=dev)
    part = (torch.empty((n_chunks, rows, width), dtype=torch.float32, device=dev)
            if n_chunks > 1 and form == "wmma" else None)
    kt = [kmajor(w) if form == "wgmma" else None for w in (a[3], m[3], m[6])]
    # a: x, ln1, wqkv_q, sqkv, bqkv, wo, bo, mask; m[1:9]: ln2, w1_q, s1, b1,
    # w2_q, s2, b2; m[9:]: out, hq, hs, y, yq, ys; each int8 weight followed
    # by its K-major copy
    ptrs = [ptr(t) for t in a[:4] + kt[:1] + a[4:] + m[1:4] + kt[1:2] + m[4:7] + kt[2:]
            + m[7:9] + [m[9], y1] + m[10:12] + [qkv, attn] + m[12:] + [part]]
    qconst = _qconst(width // heads, torch.bfloat16)
    rc = lib.aiic_int8_block(*ptrs, bsz, seq, width, heads, mlp_dim, n_chunks,
                             ctypes.c_float(eps), ctypes.c_float(qconst), form_code(name, form),
                             torch.cuda.current_stream(dev).cuda_stream)
    check(name, rc)
    return m[9]


# ---------------------------------------------------------------------------
# Public wrappers (JAX signatures)
# ---------------------------------------------------------------------------


@counted
def int8_ln_mlp(x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2,
                *, eps: float = 1e-5) -> torch.Tensor:
    """(B, S, W) -> (B, S, W): x + int8-MLP(LN(x)), on ``_mlp_plan``'s plan:
    row 2's kernel ("full"), ``int8_ln_mlp_chunked`` ("chunked"), or the
    plain version on the tensor's device ("xla")."""
    bsz, seq, width = x.shape
    mode, _, n_chunks = _mlp_plan(bsz, seq, width, w1_q.shape[-1], x.element_size())
    args = (x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2)
    if mode == "chunked":
        return int8_ln_mlp_chunked(*args, n_chunks=n_chunks, eps=eps)
    if mode == "xla" or not route("int8_ln_mlp", x):
        return int8_ln_mlp_ref(*args, eps=eps)
    out = _int8_ln_mlp_cuda(*args, eps)
    int8_ln_mlp.launches += 1
    gemm_stage.launches += 2  # c_fc and c_proj
    return out


@counted
def gemm_stage(a, w, epilogue: str, *, row_scale=None, col_scale=None, bias=None,
               x=None, n_chunks: int = 1) -> torch.Tensor:
    """(rows, K) . w (K, N) -> (rows, N) through one of the epilogues of
    rows 1-5, 10 and 11-14 (``STAGE_EPILOGUES``; ``gemm_stage_ref`` says
    what each computes; K in ``n_chunks`` chunks for the folds; dot_t takes
    w (N, K)): on the card the wgmma + TMA stage those rows run (an int8 w
    read through its cached K-major copy), on the CPU the plain version. ``launches`` also counts the stage's
    launches inside rows 1-3 (two each), row 4 (four) and the large-S int8
    projection (one): their wrappers add them where they launch. Rows 5 and
    10 (bf16) run two launches of the stage each too and count one launch
    of their own, none here."""
    if epilogue not in STAGE_EPILOGUES:
        raise ValueError(f"gemm_stage: epilogue must be one of {sorted(STAGE_EPILOGUES)}, "
                         f"got {epilogue!r}")
    kw = dict(row_scale=row_scale, col_scale=col_scale, bias=bias, x=x)
    if not route("gemm_stage", a):
        return gemm_stage_ref(a, w, epilogue, n_chunks=n_chunks, **kw)
    out = _gemm_stage_cuda(a, w, epilogue, row_scale, col_scale, bias, x, n_chunks=n_chunks)
    gemm_stage.launches += 1
    return out


@counted
def int8_ln_mlp_chunked(x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2, *, n_chunks: int,
                        eps: float = 1e-5) -> torch.Tensor:
    """(B, S, W) -> (B, S, W): the int8 MLP half with the hidden axis in
    ``n_chunks`` chunks, the gelu output quantized per (row, chunk). On the
    card each chunk must be a whole number of the wgmma stage's 128-B
    K-slices (4W/C % 128 == 0; every plan of the copied planners is): any
    other raises ValueError before a launch. The WMMA form took any 4W/C
    that is a multiple of 32, and the plain version on the CPU still takes
    any, so a direct caller with such a depth works on the CPU alone."""
    args = (x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2)
    if not route("int8_ln_mlp_chunked", x):
        return int8_ln_mlp_ref(*args, eps=eps, n_chunks=n_chunks)
    out = _int8_ln_mlp_cuda(*args, eps, n_chunks)
    int8_ln_mlp_chunked.launches += 1
    gemm_stage.launches += 2  # c_fc and the folded c_proj
    return out


def _int8_attn_large_s(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wo, bo, mask, *,
                       heads: int, eps: float) -> torch.Tensor:
    """The int8 attention half where the TPU kernel does not fit
    (``aiic_tpu/ops/quant.py::_int8_attn_large_s``): the int8 projection
    (``_int8_qkv``), the packed core (row 7) where it fits, else the
    head-grouped core (row 8) on wqkv_q, sqkv and bqkv permuted head-major
    once per weight; the bf16 out-projection, bias and residual as plain
    ops."""
    bsz, seq, width = x.shape
    itemsize = x.element_size()
    head_major = not attention_ops.qkv_core_fits(seq, width, itemsize)
    if head_major:
        wqkv_q, sqkv, bqkv = (attention_ops.headmajor_columns(t, width, heads)
                              for t in (wqkv_q, sqkv, bqkv))
    qkv = _int8_qkv(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, eps)
    if head_major:
        hg = attention_ops.pick_head_group(seq, heads, width // heads, itemsize)
        attn = attention_ops.fused_attention_qkv_headgroups(qkv, mask, heads=heads, head_group=hg)
    else:
        attn = attention_ops.fused_attention_qkv(qkv, mask, heads=heads)
    out = _mm(attn, wo.to(x.dtype)) + bo.reshape(width).float()
    return (x.float() + out).to(x.dtype)


@counted
def int8_ln_qkv_attention(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wo, bo,
                          mask=None, *, heads: int,
                          eps: float = 1e-5) -> torch.Tensor:
    """(B, S, W) -> (B, S, W): x + OutProj_bf16(Attn(QKV_int8(LN(x)))). Where
    no image group of the TPU kernel fits, ``_int8_attn_large_s`` (a head
    group of the core fits) or ``_int8_attn_rows_xla``, as the JAX package
    does."""
    bsz, seq, width = x.shape
    itemsize = x.element_size()
    args = (x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wo, bo, mask)
    if not fits_some_group(bsz, itemsize, lambda g: _attn_vmem_bytes(
            g, seq, width, itemsize) <= _VMEM_BUDGET):
        if attention_ops.pick_head_group(seq, heads, width // heads, itemsize) is not None:
            return _int8_attn_large_s(*args, heads=heads, eps=eps)
        return _int8_attn_rows_xla(*args, heads=heads, eps=eps)
    if not route("int8_ln_qkv_attention", x):
        return int8_ln_qkv_attention_ref(*args, heads=heads, eps=eps)
    out = _int8_ln_qkv_attention_cuda(*args, heads, eps)
    int8_ln_qkv_attention.launches += 1
    gemm_stage.launches += 2  # the QKV product and the out-projection
    return out


@counted
def int8_block(x, ln1_scale, ln1_bias, wqkv_q, sqkv, bqkv, wo, bo, mask, ln2_scale, ln2_bias,
               w1_q, s1, b1, w2_q, s2, b2, *, heads: int, eps: float = 1e-5,
               plan_override=None):
    """(B, S, W) -> (B, S, W): one whole int8 block, on ``_block_plan``'s
    plan (or ``plan_override``, a ("full"|"chunked", G, C) tuple); None when
    no plan fits, as the JAX package's ``int8_block`` returns. On the card
    rows 1 and 2 (or 3) in turn, in one C call; a chunked plan's 4W/C must
    be a multiple of 128 there (on the CPU any), as ``int8_ln_mlp_chunked``
    says."""
    bsz, seq, width = x.shape
    plan = plan_override or _block_plan(bsz, seq, width, w1_q.shape[-1], x.element_size())
    if plan is None:
        return None
    attn_w = (ln1_scale, ln1_bias, wqkv_q, sqkv, bqkv, wo, bo, mask)
    mlp_w = (ln2_scale, ln2_bias, w1_q, s1, b1, w2_q, s2, b2)
    if not route("int8_block", x):
        return int8_block_ref(x, *attn_w, *mlp_w, heads=heads, eps=eps, plan=plan)
    out = _int8_block_cuda(x, attn_w, mlp_w, heads, eps, plan[2] if plan[0] == "chunked" else 1)
    int8_block.launches += 1
    gemm_stage.launches += 4  # QKV, out-projection, c_fc, c_proj
    return out


# ---------------------------------------------------------------------------
# Model quantization
# ---------------------------------------------------------------------------


def _per_layer(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    qs = [quantize_weight(w[i]) for i in range(w.shape[0])]
    return torch.stack([q for q, _ in qs]), torch.stack([s for _, s in qs])


def quantize_attn_blocks(blocks: Dict[str, Any]) -> Dict[str, Any]:
    """Stacked QKV weights -> {wqkv_q, sqkv}; the output projection stays bf16."""
    wqkv_q, sqkv = _per_layer(blocks["attn"]["wqkv"])
    return {"wqkv_q": wqkv_q, "sqkv": sqkv}


def quantize_mlp_blocks(blocks: Dict[str, Any]) -> Dict[str, Any]:
    """Stacked MLP weights -> {w1_q, s1, w2_q, s2}."""
    w1_q, s1 = _per_layer(blocks["mlp"]["w1"])
    w2_q, s2 = _per_layer(blocks["mlp"]["w2"])
    return {"w1_q": w1_q, "s1": s1, "w2_q": w2_q, "s2": s2}


def quantize_model_mlp(params: Dict[str, Any], attn: bool = False,
                       towers: Tuple[str, ...] = ("visual", "text")) -> Dict[str, Any]:
    """A params tree with int8 MLP weights attached as ``blocks["mlp_q"]`` on
    the given towers (and ``blocks["attn_q"]`` with ``attn=True``); new
    dicts, the input tree is not modified. Quantize after any LoRA fold, so
    that the adapters are in the quantized weights."""
    out = dict(params)
    for tower in towers:
        t = dict(out[tower])
        blocks = dict(t["blocks"])
        blocks["mlp_q"] = quantize_mlp_blocks(blocks)
        if attn:
            blocks["attn_q"] = quantize_attn_blocks(blocks)
        t["blocks"] = blocks
        out[tower] = t
    return out


def quantize_model(params: Dict[str, Any]) -> Dict[str, Any]:
    """Full int8 serving quantization: ``attn_q`` and ``mlp_q`` on both
    towers' blocks, plus the int8 folded patch embed for the patch-major
    uint8 wire. The unquantized weights stay: the CLS-row last block and the
    fp paths use them."""
    from aiic_tpu_torch.ops.preprocess import quantize_patch_embed

    out = quantize_model_mlp(params, attn=True)
    visual = dict(out["visual"])
    visual["patch_embed_q"] = quantize_patch_embed(visual["patch_embed"])
    out["visual"] = visual
    return out
