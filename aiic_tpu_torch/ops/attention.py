"""Attention: the port of ``aiic_tpu.ops.attention``, with its Hopper kernels.

- ``exp2_rows`` / ``_denom_guard``: the clamped no-max softmax in the log2
  domain that every attention kernel runs (``scale·log2(e)`` is folded into
  Q before Q·Kᵀ; the denominator divides once after p·V).
- ``fused_attention_qkv``: the packed-QKV core (TPU kernel
  ``_attention_qkv_kernel``) on the projection's raw (B, S, 3W) layout, bf16
  or fp32; kernel ``csrc/attention_qkv.cu`` (bf16 on the tensor-core core of
  ``csrc/attn_core_mma.cuh``, fp32 on the register-tiled core of
  ``csrc/attn_core_f32.cuh``; both at any S), plain version
  ``fused_attention_qkv_ref``.
- ``fused_ln_qkv_attention``: the bf16 attention half-block (TPU kernel
  ``_ln_qkv_attention_kernel``) x + OutProj(Attn(QKV(LN x))); kernel
  ``csrc/ln_qkv_attention.cu``, plain version ``fused_ln_qkv_attention_ref``.
- ``fused_attention_qkv_headgroups``: the same core on a HEAD-MAJOR
  projection ([q_h | k_h | v_h] per head, ``headmajor_perm``), bf16 (TPU
  kernel ``_attention_qkv_hg_kernel``); kernel ``csrc/attention_qkv.cu``
  (the tensor-core core), plain version ``fused_attention_qkv_headgroups_ref``.
- ``fused_attention`` / ``flash_attention``: the same core on three separate
  (B, S, H, D) q, k, v (TPU kernel ``_attention_kernel``, row 6), bf16 or
  fp32, head dim 64 or 8; kernel ``csrc/attention.cu`` (at D=64 row 7's
  cores at any S: bf16 the tensor-core one, fp32 the register-tiled one; D=8
  on ``common.cuh``'s scalar core), plain version ``fused_attention_ref``. No
  engine reaches it, as in the JAX package.
- ``fused_attention_qkv_bwd``: the hand-written core backward on the packed
  projection (TPU kernel ``_attention_qkv_bwd_kernel``, row 9), bf16 or
  fp32; kernel ``csrc/attention_qkv_bwd.cu`` (bf16: the two tensor-core
  passes of ``csrc/attn_core_bwd_mma.cuh``; fp32: the two register-tiled
  passes of ``csrc/attn_core_bwd_f32.cuh``; both at every S), plain version
  ``fused_attention_qkv_bwd_ref``; ``fused_attention_qkv_bwd_ul_ref``
  renders in plain PyTorch how the fp32 kernel takes delta. No engine or
  trainer reaches it: ``fused_attention_qkv_vjp`` keeps the JAX package's
  autograd backward.
- ``attention_qkv_ref``: the reference stable-softmax composition on a fused
  (B, S, 3W) projection (``_attention_qkv_xla``), the ``attn_impl="xla"``
  path; ``_attention_qkv_xla_chunked`` runs it in batch chunks, where the
  JAX package finds no core that fits (fp32 at ViT-L/14@336).
- The JAX package's VMEM planners (``qkv_core_fits``, ``ln_attn_vmem_bytes``,
  ``pick_head_group`` and their budgets), copied: the card has no 16 MB
  VMEM, but the plans choose the softmax (the core kernel's clamped exp2 or
  the stable composition) and the projection's column order, so the port
  follows them to take the JAX package's branch at every geometry. Where the
  bf16 half-block does not fit (ViT-L/14 and L/14@336), ``fused_ln_qkv_attention``
  runs ``_ln_qkv_attention_large_s``: cuBLAS bf16 projections around the
  packed core (row 7) or the head-grouped one (row 8).
- ``fused_attention_qkv_vjp``: the training text tower's ``pallas_vjp``
  core: ``fused_attention_qkv``'s kernel forward under autograd, with the
  backward differentiated through ``attention_qkv_ref`` at the saved qkv,
  as JAX's custom VJP ``_fa_vjp_bwd`` differentiates ``_attention_qkv_xla``
  (the JAX package leaves that backward to XLA). The pairing is the JAX
  package's: the forward is the clamped no-max exp2 softmax, the backward
  the stable softmax's; the two differ only for rows whose scores pass the
  70-nat clamp or all underflow, which LN-bounded scores do not reach.

Each wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import numpy as np
import torch

from aiic_tpu_torch.ops._build import (
    bf16_activation, check, counted, f32_vector, load_library, mask_arg, ptr, route, weight,
)

# Clamped no-max softmax in the log2 domain: e^70 numerators keep the
# unnormalized fp32 p@v accumulation bounded (197 · e^70 · |v| ≪ fp32 max).
LOG2E = 1.4426950408889634
_EXP2_CLAMP = 70.0 * LOG2E
_HEAD_DIM = 64  # the head dim of the kernels on the packed projection
_BSHD_DIMS = (8, 64)  # the head dims row 6's kernel (separate q, k, v) is built for
_BWD_TILE_ROWS = 128  # row 9's one-tile form holds the S x S tile up to this S
# Row 9's forms on the card (the C entry's ``form``): the scalar one-tile and
# streaming forms (kept to be timed beside the forms that replaced them), the
# bf16 route and the fp32 route.
_BWD_FORMS = {"one_tile": 0, "streaming": 1, "mma": 2, "tiled": 3}
_BWD_FORM_DTYPE = {"mma": torch.bfloat16, "tiled": torch.float32}  # forms of one dtype
_MAX_SMEM = 232448  # dynamic shared memory a block may opt into on sm_90


def no_tf32() -> None:
    """The plain paths are references: float32 products must run in full
    float32 on the card, not TF32 (cuDNN's default is TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 accumulation and an fp32 result. Two bf16 operands on
    the card run on the bf16 tensor cores through cuBLAS with an fp32 output
    (exact products, fp32 sums) where no gradient is asked for (that
    overload has no derivative); anything else is lifted to fp32 with TF32
    off, which is exact for bf16 operands too."""
    if (a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16
            and not (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad))):
        y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return y.reshape(*a.shape[:-1], b.shape[-1])
    no_tf32()
    return a.float() @ b.float()


# ---------------------------------------------------------------------------
# The JAX package's VMEM planners (aiic_tpu/ops/attention.py), copied as
# routing: each budget is a module constant so a test can patch it on both
# sides.
# ---------------------------------------------------------------------------

_CORE_VMEM_BUDGET = 14 * 1024 * 1024
# Device-memory budget of the chunked reference core's (chunk, H, S, S) fp32
# scores, and of the chunked int8 attention reference (ops.quant).
_FALLBACK_PROBS_BUDGET = 1 << 30


def qkv_core_vmem_bytes(group: int, seq: int, width: int, itemsize: int) -> int:
    """The TPU packed core's VMEM estimate for one program of ``group`` images."""
    return (2 * group * seq * 4 * width * itemsize
            + 3 * seq * seq * 4
            + 3 * group * seq * width * itemsize)


def qkv_core_fits(seq: int, width: int, itemsize: int, group: int = 1) -> bool:
    return qkv_core_vmem_bytes(group, seq, width, itemsize) <= _CORE_VMEM_BUDGET


def ln_attn_vmem_bytes(group: int, seq: int, width: int, itemsize: int) -> int:
    """The TPU bf16 attention half-block's VMEM estimate (the int8 one's
    terms with the QKV weight in the compute dtype)."""
    rows = group * seq
    return (2 * rows * width * itemsize
            + 3 * width * width * itemsize
            + width * width * itemsize
            + rows * width * 4
            + rows * 3 * width * 4
            + rows * 3 * width * itemsize
            + 2 * seq * seq * 4
            + rows * width * 4)


def headmajor_perm(width: int, heads: int) -> np.ndarray:
    """Column permutation of the packed [Q | K | V] projection into the
    head-major [q_h0 | k_h0 | v_h0 | q_h1 | ...] layout (3·dim per head)."""
    d = width // heads
    idx = []
    for h in range(heads):
        idx.extend(range(h * d, (h + 1) * d))
        idx.extend(range(width + h * d, width + (h + 1) * d))
        idx.extend(range(2 * width + h * d, 2 * width + (h + 1) * d))
    return np.asarray(idx, np.int32)


def pick_head_group(seq: int, heads: int, dim: int, itemsize: int) -> Optional[int]:
    """Largest head group whose core fits the budget (None if one head does not)."""
    hg = heads
    while hg >= 1:
        if heads % hg == 0 and qkv_core_vmem_bytes(1, seq, hg * dim, itemsize) <= _CORE_VMEM_BUDGET:
            return hg
        hg //= 2
    return None


def fits_some_group(bsz: int, itemsize: int, fits: Callable[[int], bool]) -> bool:
    """The TPU wrappers' image-group rule: start at 2 images (bf16) or 1
    (fp32), halve until the group divides the batch and fits; whether the
    group it ends at fits."""
    group = 2 if itemsize <= 2 else 1
    while bsz % group:
        group //= 2
    group = max(group, 1)
    while group > 1 and not fits(group):
        group //= 2
    return fits(group)


def headmajor_columns(t: torch.Tensor, width: int, heads: int,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``t`` with its last axis in ``headmajor_perm`` order (and cast to
    ``dtype``), computed once per weight: the copy is cached on the tensor
    that owns t's storage (the stacked weight of all layers, for a layer's
    view), keyed by the view's offset and shape, and goes with it. The JAX
    package permutes at trace time; serving weights are not modified in
    place, which the cache assumes."""
    owner = t if t._base is None else t._base
    cache = owner.__dict__.setdefault("_aiic_headmajor", {})
    key = (t.storage_offset(), tuple(t.shape), tuple(t.stride()), dtype, width, heads)
    hit = cache.get(key)
    if hit is None:
        perm = torch.from_numpy(headmajor_perm(width, heads)).to(device=t.device, dtype=torch.long)
        hit = cache[key] = t.index_select(-1, perm).to(dtype or t.dtype).contiguous()
    return hit


def exp2_rows(s: torch.Tensor) -> torch.Tensor:
    """Unnormalized softmax numerators without the max pass, for scores
    already in the log2 domain: ``exp2(min(s, 70·log2 e))``. 0 and -inf
    mask entries are fixed points of the clamp."""
    return torch.exp2(torch.clamp(s, max=_EXP2_CLAMP))


def _denom_guard(denom: torch.Tensor) -> torch.Tensor:
    """Floor the folded denominator at 1e-38 so a row whose scores all
    underflow gives an all-zero attention row instead of 0/0."""
    return torch.clamp(denom, min=1e-38)


def _ln_fp32(xf: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics and an fp32 result, as the TPU kernels
    compute it before their cast (to the compute dtype, or into the int8
    row quantizer)."""
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    h = (xf - mean) * torch.rsqrt(var + eps)
    return h * scale.float() + bias.float()


def _split_heads(qkv: torch.Tensor, heads: int):
    bsz, seq, w3 = qkv.shape
    width = w3 // 3
    dim = width // heads
    qkv = qkv.reshape(bsz, seq, 3, heads, dim)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, S, H, D) each


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def attention_qkv_ref(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                      heads: int) -> torch.Tensor:
    """Softmax attention on a fused (B, S, 3W) [Q|K|V] projection; products
    accumulate in fp32, the softmax is the stable one, probabilities are
    cast to the compute dtype before p·V."""
    no_tf32()
    bsz, seq, w3 = qkv.shape
    q, k, v = _split_heads(qkv, heads)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(qkv.dtype).reshape(bsz, seq, w3 // 3)


def _fallback_chunk(bsz: int, heads: int, seq: int) -> int:
    """The JAX package's batch chunk for a plain core: the largest divisor
    of the batch whose fp32 (chunk, H, S, S) scores fit
    ``_FALLBACK_PROBS_BUDGET``."""
    chunk = max(1, min(bsz, _FALLBACK_PROBS_BUDGET // (heads * seq * seq * 4)))
    while bsz % chunk:
        chunk -= 1
    return chunk


def _attention_qkv_xla_chunked(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                               heads: int) -> torch.Tensor:
    """``attention_qkv_ref`` in batch chunks whose fp32 (chunk, H, S, S)
    scores stay under ``_FALLBACK_PROBS_BUDGET`` (the JAX package's chunk
    rule); the same per-image math. Where no core fits (fp32 at S=577) the
    JAX package runs this in XLA, and the port in plain PyTorch on the
    tensor's device."""
    bsz, seq, _ = qkv.shape
    chunk = _fallback_chunk(bsz, heads, seq)
    if chunk == bsz:
        return attention_qkv_ref(qkv, mask, heads)
    return torch.cat([attention_qkv_ref(qkv[i:i + chunk], mask, heads)
                      for i in range(0, bsz, chunk)])


def _core_ref(q, k, v, mask, dtype) -> torch.Tensor:
    """The TPU cores' math on (B, S, H, D) q, k, v in ``dtype``; (B, S, H·D)."""
    bsz, seq, heads, dim = q.shape
    q = q * torch.tensor(dim ** -0.5 * LOG2E, dtype=q.dtype, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if mask is not None:
        s = s + mask.float() * LOG2E
    p = exp2_rows(s)
    denom = _denom_guard(p.sum(dim=-1, keepdim=True))  # (B, H, S, 1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = o * (1.0 / denom.permute(0, 2, 1, 3))
    return out.to(dtype).reshape(bsz, seq, heads * dim)


def fused_attention_qkv_ref(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                            heads: int) -> torch.Tensor:
    """The TPU kernel's core (``_attention_qkv_kernel``) on a fused (B, S, 3W)
    projection, in qkv's dtype: Q scaled by ``scale·log2 e`` rounded to that
    dtype, fp32 scores plus ``mask·log2 e``, the clamped no-max exp2
    softmax, p rounded to the dtype before p·V, the fp32 denominator folded
    in after p·V as a reciprocal, the output rounded to the dtype. In fp32
    none of the roundings do anything."""
    no_tf32()
    q, k, v = _split_heads(qkv, heads)
    return _core_ref(q, k, v, mask, qkv.dtype)


def fused_attention_qkv_headgroups_ref(qkv_hm: torch.Tensor, mask: Optional[torch.Tensor],
                                       heads: int) -> torch.Tensor:
    """``fused_attention_qkv_ref`` on a head-major (B, S, 3W) projection
    (``_attention_qkv_hg_kernel``); the output is the head concat. The head
    group is the TPU's tiling and does not enter the math."""
    no_tf32()
    bsz, seq, w3 = qkv_hm.shape
    t = qkv_hm.reshape(bsz, seq, heads, 3, w3 // 3 // heads)
    return _core_ref(t[:, :, :, 0], t[:, :, :, 1], t[:, :, :, 2], mask, qkv_hm.dtype)


def fused_ln_qkv_attention_ref(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, mask=None,
                               *, heads: int, eps: float = 1e-5) -> torch.Tensor:
    """(B, S, W) -> x + OutProj(Attn(QKV(LN(x)))) with the TPU kernel's
    roundings (``_ln_qkv_attention_kernel``): LN in fp32 cast to x's dtype,
    qkv = dtype(h·Wqkv + bqkv) with fp32 sums, the core of
    ``fused_attention_qkv_ref``, out = dtype(xf + (attn·Wo + bo))."""
    no_tf32()
    bsz, seq, width = x.shape
    xf = x.float()
    h = _ln_fp32(xf, ln_scale.reshape(1, width), ln_bias.reshape(1, width), eps).to(x.dtype)
    qkv = h.float() @ wqkv.to(x.dtype).float() + bqkv.reshape(1, 3 * width).float()
    attn = fused_attention_qkv_ref(qkv.to(x.dtype), mask, heads)
    out = attn.float() @ wo.to(x.dtype).float() + bo.reshape(1, width).float()
    return (xf + out).to(x.dtype)


def fused_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The TPU kernel's core (``_attention_kernel``) on (B, S, H, D) q, k, v,
    in q's dtype: the math of ``fused_attention_qkv_ref`` on separate
    arrays. The TPU kernel's padding of S and D to 128 (padded keys masked
    with -inf, padded D columns zero) is layout and does not enter it."""
    no_tf32()
    return _core_ref(q, k, v, mask, q.dtype).reshape(q.shape)


def fused_attention_qkv_bwd_ref(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                                g: torch.Tensor, *, heads: int) -> torch.Tensor:
    """The TPU kernel's core backward (``_attention_qkv_bwd_kernel``) on a
    fused (B, S, 3W) projection and a (B, S, W) cotangent, in qkv's dtype T:
    p recomputed with the forward's clamped no-max exp2 (q·T(scale·log2 e)
    rounded to T, fp32 scores plus mask·log2 e) and normalized in fp32;
    dv = T(p)ᵀ·T(g); dp = T(g)·vᵀ; ds = T(p∘(dp − rowsum(dp∘p))·scale);
    dq = ds·k; dk = dsᵀ·q; products in fp32. ``mask`` None is no mask."""
    no_tf32()
    dtype = qkv.dtype
    bsz, seq, w3 = qkv.shape
    dim = w3 // 3 // heads
    scale = dim ** -0.5
    q, k, v = _split_heads(qkv, heads)
    gh = g.to(dtype).reshape(bsz, seq, heads, dim).float()
    qs = q * torch.tensor(scale * LOG2E, dtype=dtype, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if mask is not None:
        s = s + mask.float() * LOG2E
    p = exp2_rows(s)
    p = p * (1.0 / _denom_guard(p.sum(dim=-1, keepdim=True)))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dtype).float(), gh)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, v.float())
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = (ds * scale).to(dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return torch.cat([t.reshape(bsz, seq, w3 // 3) for t in (dq, dk, dv)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# Hopper kernels (aiic_tpu_torch/csrc), launched through ctypes
# ---------------------------------------------------------------------------


def fused_attention_qkv_bwd_ul_ref(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                                   g: torch.Tensor, *, heads: int) -> torch.Tensor:
    """``fused_attention_qkv_bwd_ref`` in fp32 as the register-tiled kernel
    takes it: delta = rowsum(e∘dp)·inv, summed beside l = rowsum(e) (e the
    clamped exp2 numerators, inv = 1/max(l, 1e-38)), in place of
    rowsum(p∘dp) after l; p = e·inv. The two differ by fp32 rounding."""
    if qkv.dtype != torch.float32:
        raise ValueError(f"the u/l form is fp32's, got {qkv.dtype}")
    no_tf32()
    bsz, seq, w3 = qkv.shape
    dim = w3 // 3 // heads
    scale = dim ** -0.5
    q, k, v = _split_heads(qkv, heads)
    gh = g.float().reshape(bsz, seq, heads, dim)
    qs = q * torch.tensor(scale * LOG2E, dtype=torch.float32, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k)
    if mask is not None:
        s = s + mask.float() * LOG2E
    e = exp2_rows(s)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, v)
    inv = 1.0 / _denom_guard(e.sum(dim=-1, keepdim=True))
    delta = (e * dp).sum(dim=-1, keepdim=True) * inv
    p = e * inv
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gh)
    ds = (p * (dp - delta)) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return torch.cat([t.reshape(bsz, seq, w3 // 3) for t in (dq, dk, dv)], dim=-1)


def _qconst(dim: int, dtype: torch.dtype) -> float:
    """``scale·log2 e`` rounded to the compute dtype, as
    ``jnp.asarray(scale * LOG2E, q.dtype)``."""
    return float(torch.tensor(dim ** -0.5 * LOG2E, dtype=dtype))


def _scalar_form(name: str, dtype: torch.dtype, form: Optional[str], dim: int = _HEAD_DIM) -> bool:
    """Whether ``form`` runs fp32 rows 6-7 at head dim 64 on the scalar core
    that the register-tiled one (the route, ``None``) replaced: ``"scalar"``,
    the C entries' ``scalar`` flag, kept to be timed beside it. ValueError
    on any other form, or where fp32 at head dim 64 is not asked."""
    if form is None:
        return False
    if form != "scalar" or dtype != torch.float32 or dim != _HEAD_DIM:
        raise ValueError(f"{name}: no {form!r} form for {dtype} at head dim {dim} (fp32 at head "
                         f"dim {_HEAD_DIM} has the 'scalar' one)")
    return True


def _check_core_shape(name: str, seq: int, width: int, heads: int, itemsize: int,
                      tiled: bool = False) -> None:
    """Head dim 64; for the scalar core (not ``tiled``) K and V of one head
    within a block's shared memory. The tensor-core (bf16) and
    register-tiled (fp32) cores of rows 6-8 (``tiled``) stream K and V in
    fixed tiles and take any S."""
    if width % heads or width // heads != _HEAD_DIM:
        raise ValueError(f"{name} kernel needs head_dim {_HEAD_DIM}, got W={width}, H={heads}")
    if not tiled and 2 * seq * _HEAD_DIM * itemsize > _MAX_SMEM:
        raise ValueError(f"{name} kernel: K and V of one head at S={seq} exceed shared memory")


def _fused_attention_qkv_cuda(qkv, mask, heads, form: Optional[str] = None):
    """Row 7 on the card: bf16 on the tensor-core core, fp32 on the
    register-tiled core, both at any S; ``form="scalar"`` runs fp32 on the
    scalar core that the register-tiled one replaced (K and V of a head
    within shared memory). Raises ValueError on what a form does not take,
    before the library loads."""
    if qkv.dtype not in (torch.float32, torch.bfloat16) or qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise TypeError(f"fused_attention_qkv: the Hopper kernel takes fp32 or bf16 (B, S, 3W), "
                        f"got {qkv.dtype} {tuple(qkv.shape)}")
    bsz, seq, w3 = qkv.shape
    width = w3 // 3
    scalar = _scalar_form("fused_attention_qkv", qkv.dtype, form)
    _check_core_shape("fused_attention_qkv", seq, width, heads, qkv.element_size(),
                      tiled=not scalar)
    qkv = qkv.contiguous()
    dev = qkv.device
    if qkv.data_ptr() % 16:
        raise ValueError("fused_attention_qkv: qkv must be 16-byte aligned")
    lib = load_library()
    mask = mask_arg(mask, seq, dev)
    out = torch.empty((bsz, seq, width), dtype=qkv.dtype, device=dev)
    fp32 = qkv.dtype == torch.float32
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.aiic_attention_qkv(ptr(qkv), ptr(mask), ptr(out), bsz, seq, width, heads,
                                ctypes.c_float(_qconst(width // heads, qkv.dtype)), int(fp32),
                                int(scalar), stream)
    check("fused_attention_qkv", rc)
    return out


def _fused_attention_qkv_headgroups_cuda(qkv_hm, mask, heads, head_group):
    name = "fused_attention_qkv_headgroups"
    if qkv_hm.dtype != torch.bfloat16 or qkv_hm.dim() != 3 or qkv_hm.shape[-1] % 3:
        raise TypeError(f"{name}: the Hopper kernel takes bf16 (B, S, 3W) (fp32 has no "
                        f"tensor-core path that holds its 1e-5 bar), got {qkv_hm.dtype} "
                        f"{tuple(qkv_hm.shape)}")
    bsz, seq, w3 = qkv_hm.shape
    width = w3 // 3
    _check_core_shape(name, seq, width, heads, 2, tiled=True)
    lib = load_library()
    qkv_hm = qkv_hm.contiguous()
    dev = qkv_hm.device
    if qkv_hm.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be 16-byte aligned")
    mask = mask_arg(mask, seq, dev)
    out = torch.empty((bsz, seq, width), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.aiic_attention_qkv_hg(ptr(qkv_hm), ptr(mask), ptr(out), bsz, seq, width, heads,
                                   head_group, ctypes.c_float(_qconst(width // heads,
                                                                      torch.bfloat16)), stream)
    check(name, rc)
    return out


def mma_core_occupancy() -> int:
    """Blocks of the bf16 tensor-core core (rows 6 bf16, 7 bf16 and 8)
    resident on one SM of the current card, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives them."""
    blocks = ctypes.c_int(0)
    check("attn_core_mma occupancy", load_library().aiic_attention_qkv_mma_occupancy(
        ctypes.byref(blocks)))
    return blocks.value


def mma_bwd_occupancy() -> tuple:
    """Blocks of the bf16 tensor-core backward's two passes (row 9: query
    rows, key rows) resident on one SM of the current card."""
    blocks = (ctypes.c_int * 2)()
    check("attn_core_bwd_mma occupancy",
          load_library().aiic_attention_qkv_bwd_mma_occupancy(blocks))
    return blocks[0], blocks[1]


def f32_core_occupancy() -> int:
    """Blocks of the fp32 register-tiled core (rows 6 and 7) resident on one
    SM of the current card."""
    blocks = ctypes.c_int(0)
    check("attn_core_f32 occupancy", load_library().aiic_attention_f32_occupancy(
        ctypes.byref(blocks)))
    return blocks.value


def tiled_bwd_occupancy() -> tuple:
    """Blocks of the fp32 register-tiled backward's two passes (row 9)
    resident on one SM of the current card."""
    blocks = (ctypes.c_int * 2)()
    check("attn_core_bwd_f32 occupancy",
          load_library().aiic_attention_qkv_bwd_tiled_occupancy(blocks))
    return blocks[0], blocks[1]


def _fused_ln_qkv_attention_cuda(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, mask, heads, eps):
    name = "fused_ln_qkv_attention"
    bf16_activation(name, x)
    bsz, seq, width = x.shape
    if width % 128:
        raise ValueError(f"{name} kernel needs W % 128 == 0, got W={width}")
    _check_core_shape(name, seq, width, heads, 2)
    lib = load_library()
    rows = bsz * seq
    x = x.contiguous()
    dev = x.device
    wqkv = weight(name, wqkv, (width, 3 * width), torch.bfloat16, dev)
    wo = weight(name, wo, (width, width), torch.bfloat16, dev)
    mask = mask_arg(mask, seq, dev)
    out = torch.empty_like(x)
    h = torch.empty((rows, width), dtype=torch.bfloat16, device=dev)
    qkv = torch.empty((rows, 3 * width), dtype=torch.bfloat16, device=dev)
    attn = torch.empty((rows, width), dtype=torch.bfloat16, device=dev)
    args = [x, f32_vector(ln_scale, width, dev), f32_vector(ln_bias, width, dev), wqkv,
            f32_vector(bqkv, 3 * width, dev), wo, f32_vector(bo, width, dev), mask, out,
            h, qkv, attn]
    # Scratch freed on return is reused by the caching allocator only for
    # work queued later on this same stream, so that is safe.
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.aiic_ln_qkv_attention(
        *[ptr(a) for a in args], bsz, seq, width, heads, ctypes.c_float(eps),
        ctypes.c_float(_qconst(width // heads, torch.bfloat16)), stream)
    check(name, rc)
    return out


def _fused_attention_cuda(q, k, v, mask, form: Optional[str] = None):
    """Row 6 on the card: at D=64 bf16 on the tensor-core core and fp32 on
    the register-tiled core (any S), at D=8 the scalar core; ``form="scalar"``
    runs fp32 at D=64 on the scalar core that the register-tiled one
    replaced. Raises ValueError on what a form does not take, before the
    library loads."""
    name = "fused_attention"
    if (q.dtype not in (torch.float32, torch.bfloat16) or q.dim() != 4
            or any(t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                   for t in (k, v))):
        raise ValueError(f"{name}: the Hopper kernel takes fp32 or bf16 (B, S, H, D) q, k, v of "
                         f"one shape, type and device, got {q.dtype} {tuple(q.shape)}, "
                         f"{k.dtype} {tuple(k.shape)}, {v.dtype} {tuple(v.shape)}")
    bsz, seq, heads, dim = q.shape
    if dim not in _BSHD_DIMS:
        raise ValueError(f"{name}: the Hopper kernel is built for head dims {_BSHD_DIMS}, got {dim}")
    # At D=64 the tensor-core (bf16) and register-tiled (fp32) cores stream K
    # and V in tiles and take any S; the scalar core holds K and V of a head.
    scalar = _scalar_form(name, q.dtype, form, dim)
    tiled = dim == _HEAD_DIM and not scalar
    if seq < 1 or (not tiled and 2 * seq * dim * q.element_size() > _MAX_SMEM):
        raise ValueError(f"{name}: K and V of one head at S={seq} do not fit shared memory")
    q, k, v = (t.contiguous() for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must be 16-byte aligned")
    lib = load_library()
    dev = q.device
    mask = mask_arg(mask, seq, dev)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.aiic_attention_bshd(ptr(q), ptr(k), ptr(v), ptr(mask), ptr(out), bsz, seq, heads,
                                 dim, ctypes.c_float(_qconst(dim, q.dtype)),
                                 int(q.dtype == torch.float32), int(scalar), stream)
    check(name, rc)
    return out


def _fused_attention_qkv_bwd_cuda(qkv, mask, g, heads, form: str):
    """Row 9 on the card in one of its forms: ``"mma"`` the tensor-core
    passes (bf16, any S; the public wrapper's bf16 route), ``"tiled"`` the
    register-tiled passes (fp32, any S; the fp32 route), ``"one_tile"``
    common.cuh's one-tile kernel (S <= 128) or ``"streaming"`` the two
    scalar passes (the two scalar forms agree bit for bit where both apply).
    Raises ValueError on what a form does not take, before the library
    loads."""
    name = "fused_attention_qkv_bwd"
    if qkv.dtype not in (torch.float32, torch.bfloat16) or qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"{name}: the Hopper kernel takes fp32 or bf16 (B, S, 3W), got "
                         f"{qkv.dtype} {tuple(qkv.shape)}")
    if form not in _BWD_FORMS or _BWD_FORM_DTYPE.get(form, qkv.dtype) != qkv.dtype:
        raise ValueError(f"{name}: no {form!r} form for {qkv.dtype} (forms {list(_BWD_FORMS)}; "
                         f"the tensor-core one takes bf16, the register-tiled one fp32)")
    bsz, seq, w3 = qkv.shape
    width = w3 // 3
    if width % heads or width // heads != _HEAD_DIM:
        raise ValueError(f"{name}: the Hopper kernel needs head_dim {_HEAD_DIM}, got W={width}, "
                         f"H={heads}")
    if seq < 1 or (form == "one_tile" and seq > _BWD_TILE_ROWS):
        raise ValueError(f"{name}: the one-tile kernel takes 1 <= S <= {_BWD_TILE_ROWS}, got {seq}")
    if g.shape != (bsz, seq, width) or g.device != qkv.device:
        raise ValueError(f"{name}: g must be {(bsz, seq, width)} on {qkv.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    lib = load_library()
    dev = qkv.device
    qkv, g = qkv.contiguous(), g.to(qkv.dtype).contiguous()
    if form in _BWD_FORM_DTYPE and (qkv.data_ptr() % 16 or g.data_ptr() % 16):
        raise ValueError(f"{name}: qkv and g must be 16-byte aligned for the {form} form")
    mask = mask_arg(mask, seq, dev)
    if mask is None and form not in _BWD_FORM_DTYPE:  # the scalar forms read a mask always
        mask = torch.zeros((seq, seq), dtype=torch.float32, device=dev)
    out = torch.empty_like(qkv)
    ws = (torch.empty(2 * bsz * heads * seq, dtype=torch.float32, device=dev)
          if form != "one_tile" else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.aiic_attention_qkv_bwd(ptr(qkv), ptr(mask), ptr(g), ptr(out), ptr(ws), bsz, seq,
                                    width, heads, ctypes.c_float(_qconst(_HEAD_DIM, qkv.dtype)),
                                    int(qkv.dtype == torch.float32), _BWD_FORMS[form], stream)
    check(name, rc)
    return out


# ---------------------------------------------------------------------------
# Public wrappers (JAX signatures)
# ---------------------------------------------------------------------------


@counted
def fused_attention_qkv(qkv: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                        heads: int) -> torch.Tensor:
    """(B, S, 3W) packed [Q|K|V] -> (B, S, W) attention output, no transposes.
    Where no image group of the TPU core fits (fp32 at S=577), the
    batch-chunked reference composition instead, as the JAX package does."""
    bsz, seq, w3 = qkv.shape
    itemsize = qkv.element_size()
    if not fits_some_group(bsz, itemsize, lambda g: qkv_core_fits(seq, w3 // 3, itemsize, g)):
        return _attention_qkv_xla_chunked(qkv, mask, heads)
    if not route("fused_attention_qkv", qkv):
        return fused_attention_qkv_ref(qkv, mask, heads)
    out = _fused_attention_qkv_cuda(qkv, mask, heads)
    fused_attention_qkv.launches += 1
    return out


@counted
def fused_attention_qkv_headgroups(qkv_hm: torch.Tensor, mask: Optional[torch.Tensor] = None,
                                   *, heads: int, head_group: int) -> torch.Tensor:
    """HEAD-MAJOR (B, S, 3W) -> (B, S, W) head-concat attention output, in
    grid rows of ``head_group`` heads."""
    if heads % head_group:
        raise ValueError(f"head_group {head_group} does not divide heads {heads}")
    if not route("fused_attention_qkv_headgroups", qkv_hm):
        return fused_attention_qkv_headgroups_ref(qkv_hm, mask, heads)
    out = _fused_attention_qkv_headgroups_cuda(qkv_hm, mask, heads, head_group)
    fused_attention_qkv_headgroups.launches += 1
    return out


def _ln_qkv_attention_large_s(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, mask, *,
                              heads: int, eps: float) -> torch.Tensor:
    """The bf16/fp32 half-block where the TPU kernel does not fit
    (``aiic_tpu/ops/attention.py::_ln_qkv_attention_large_s``): LN and the
    QKV product as plain ops (cuBLAS), the packed core (row 7) where it fits,
    else the head-grouped core (row 8) on weights permuted head-major once,
    else the chunked reference core; the out-projection and the residual as
    plain ops."""
    bsz, seq, width = x.shape
    dtype, itemsize = x.dtype, x.element_size()
    hg = None
    head_major = not qkv_core_fits(seq, width, itemsize)
    if head_major:
        hg = pick_head_group(seq, heads, width // heads, itemsize)
    if hg is not None:
        wqkv = headmajor_columns(wqkv, width, heads, dtype)
        bqkv = headmajor_columns(bqkv.reshape(3 * width), width, heads, torch.float32)
    xf = x.float()
    h = _ln_fp32(xf, ln_scale.reshape(1, width), ln_bias.reshape(1, width), eps).to(dtype)
    qkv = (_mm(h, wqkv.to(dtype)) + bqkv.reshape(3 * width).float()).to(dtype)
    if not head_major:
        attn = fused_attention_qkv(qkv, mask, heads=heads)
    elif hg is not None:
        attn = fused_attention_qkv_headgroups(qkv, mask, heads=heads, head_group=hg)
    else:
        attn = _attention_qkv_xla_chunked(qkv, mask, heads)
    out = _mm(attn, wo.to(dtype)) + bo.reshape(width).float()
    return (xf + out).to(dtype)


@counted
def fused_ln_qkv_attention(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, mask=None, *,
                           heads: int, eps: float = 1e-5) -> torch.Tensor:
    """(B, S, W) -> (B, S, W): x + OutProj(Attention(QKV(LN(x)))). Where no
    image group of the TPU kernel fits (ViT-L/14 and L/14@336), the large-S
    composition of ``_ln_qkv_attention_large_s`` instead, as the JAX package
    does."""
    bsz, seq, width = x.shape
    itemsize = x.element_size()
    if not fits_some_group(bsz, itemsize, lambda g: ln_attn_vmem_bytes(
            g, seq, width, itemsize) <= _CORE_VMEM_BUDGET):
        return _ln_qkv_attention_large_s(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, mask,
                                         heads=heads, eps=eps)
    if not route("fused_ln_qkv_attention", x):
        return fused_ln_qkv_attention_ref(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, mask,
                                          heads=heads, eps=eps)
    out = _fused_ln_qkv_attention_cuda(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, mask,
                                       heads, eps)
    fused_ln_qkv_attention.launches += 1
    return out


@counted
def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, *, block_pairs: int = 8) -> torch.Tensor:
    """(B, S, H, D) q, k, v -> (B, S, H, D) in q's dtype; ``mask`` an
    additive (S, S) float or None. ``block_pairs`` is the TPU grid's
    (batch, head) pairs per step: accepted for the signature, it does not
    enter the math."""
    del block_pairs
    if not route("fused_attention", q):
        return fused_attention_ref(q, k, v, mask)
    out = _fused_attention_cuda(q, k, v, mask)
    fused_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's dispatch: the kernel for a CUDA tensor, the plain
    version for a CPU one, so it is valid on every device."""
    return fused_attention(q, k, v, mask)


@counted
def fused_attention_qkv_bwd(qkv: torch.Tensor, mask: Optional[torch.Tensor], g: torch.Tensor, *,
                            heads: int) -> torch.Tensor:
    """(B, S, 3W) qkv, (S, S) additive mask (None: none) and (B, S, W) output
    cotangent -> (B, S, 3W) qkv cotangent in qkv's dtype; g is cast to qkv's
    dtype, as ``_fa_vjp_bwd`` casts it. On the card: bf16 on the tensor-core
    passes, fp32 on the register-tiled passes, at every S."""
    g = g.to(qkv.dtype)
    if not route("fused_attention_qkv_bwd", qkv):
        return fused_attention_qkv_bwd_ref(qkv, mask, g, heads=heads)
    form = "mma" if qkv.dtype == torch.bfloat16 else "tiled"
    out = _fused_attention_qkv_bwd_cuda(qkv, mask, g, heads, form)
    fused_attention_qkv_bwd.launches += 1
    return out


class _AttentionQKVVJP(torch.autograd.Function):
    """Kernel forward; backward through the stable-softmax composition."""

    @staticmethod
    def forward(ctx, qkv, mask, heads):
        ctx.heads = heads
        ctx.save_for_backward(qkv, mask)
        return fused_attention_qkv(qkv, mask, heads=heads)

    @staticmethod
    def backward(ctx, g):
        qkv, mask = ctx.saved_tensors
        with torch.enable_grad():
            t = qkv.detach().requires_grad_()
            out = attention_qkv_ref(t, mask, ctx.heads)
            (dqkv,) = torch.autograd.grad(out, t, g.to(qkv.dtype))
        return dqkv, None, None


def fused_attention_qkv_vjp(qkv: torch.Tensor, mask: torch.Tensor, heads: int) -> torch.Tensor:
    """Differentiable (B, S, 3W) -> (B, S, W) core for training: the kernel
    forward, the stable-softmax backward. ``mask`` is a concrete (S, S)
    tensor (zeros for none) and gets no gradient."""
    return _AttentionQKVVJP.apply(qkv, mask, heads)
