"""Attention: the port of the parts of ``aiic_tpu.ops.attention`` that the
serving paths run, with two Hopper kernels.

- ``exp2_rows`` / ``_denom_guard``: the clamped no-max softmax in the log2
  domain that every attention kernel runs (``scale·log2(e)`` is folded into
  Q before Q·Kᵀ; the denominator divides once after p·V).
- ``fused_attention_qkv``: the packed-QKV core (TPU kernel
  ``_attention_qkv_kernel``) on the projection's raw (B, S, 3W) layout, bf16
  or fp32; kernel ``csrc/attention_qkv.cu``, plain version
  ``fused_attention_qkv_ref``.
- ``fused_ln_qkv_attention``: the bf16 attention half-block (TPU kernel
  ``_ln_qkv_attention_kernel``) x + OutProj(Attn(QKV(LN x))); kernel
  ``csrc/ln_qkv_attention.cu``, plain version ``fused_ln_qkv_attention_ref``.
- ``attention_qkv_ref``: the reference stable-softmax composition on a fused
  (B, S, 3W) projection (``_attention_qkv_xla``), the ``attn_impl="xla"``
  path.
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
from typing import Optional

import torch

from aiic_tpu_torch.ops._build import (
    bf16_activation, check, counted, f32_vector, load_library, mask_arg, ptr, route, weight,
)

# Clamped no-max softmax in the log2 domain: e^70 numerators keep the
# unnormalized fp32 p@v accumulation bounded (197 · e^70 · |v| ≪ fp32 max).
LOG2E = 1.4426950408889634
_EXP2_CLAMP = 70.0 * LOG2E
_HEAD_DIM = 64  # the only head dim the Hopper kernels take
_MAX_SMEM = 232448  # dynamic shared memory a block may opt into on sm_90


def no_tf32() -> None:
    """The plain paths are references: float32 products must run in full
    float32 on the card, not TF32 (cuDNN's default is TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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


def fused_attention_qkv_ref(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                            heads: int) -> torch.Tensor:
    """The TPU kernel's core (``_attention_qkv_kernel``) on a fused (B, S, 3W)
    projection, in qkv's dtype: Q scaled by ``scale·log2 e`` rounded to that
    dtype, fp32 scores plus ``mask·log2 e``, the clamped no-max exp2
    softmax, p rounded to the dtype before p·V, the fp32 denominator folded
    in after p·V as a reciprocal, the output rounded to the dtype. In fp32
    none of the roundings do anything."""
    no_tf32()
    bsz, seq, w3 = qkv.shape
    q, k, v = _split_heads(qkv, heads)
    q = q * torch.tensor(q.shape[-1] ** -0.5 * LOG2E, dtype=q.dtype, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if mask is not None:
        s = s + mask.float() * LOG2E
    p = exp2_rows(s)
    denom = _denom_guard(p.sum(dim=-1, keepdim=True))  # (B, H, S, 1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = o * (1.0 / denom.permute(0, 2, 1, 3))
    return out.to(qkv.dtype).reshape(bsz, seq, w3 // 3)


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


# ---------------------------------------------------------------------------
# Hopper kernels (aiic_tpu_torch/csrc), launched through ctypes
# ---------------------------------------------------------------------------


def _qconst(dim: int, dtype: torch.dtype) -> float:
    """``scale·log2 e`` rounded to the compute dtype, as
    ``jnp.asarray(scale * LOG2E, q.dtype)``."""
    return float(torch.tensor(dim ** -0.5 * LOG2E, dtype=dtype))


def _check_core_shape(name: str, seq: int, width: int, heads: int, itemsize: int) -> None:
    if width % heads or width // heads != _HEAD_DIM:
        raise ValueError(f"{name} kernel needs head_dim {_HEAD_DIM}, got W={width}, H={heads}")
    if 2 * seq * _HEAD_DIM * itemsize > _MAX_SMEM:
        raise ValueError(f"{name} kernel: K and V of one head at S={seq} exceed shared memory")


def _fused_attention_qkv_cuda(qkv, mask, heads):
    if qkv.dtype not in (torch.float32, torch.bfloat16) or qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise TypeError(f"fused_attention_qkv: the Hopper kernel takes fp32 or bf16 (B, S, 3W), "
                        f"got {qkv.dtype} {tuple(qkv.shape)}")
    bsz, seq, w3 = qkv.shape
    width = w3 // 3
    _check_core_shape("fused_attention_qkv", seq, width, heads, qkv.element_size())
    lib = load_library()
    qkv = qkv.contiguous()
    dev = qkv.device
    if qkv.data_ptr() % 16:
        raise ValueError("fused_attention_qkv: qkv must be 16-byte aligned")
    mask = mask_arg(mask, seq, dev)
    out = torch.empty((bsz, seq, width), dtype=qkv.dtype, device=dev)
    fp32 = qkv.dtype == torch.float32
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.aiic_attention_qkv(ptr(qkv), ptr(mask), ptr(out), bsz, seq, width, heads,
                                ctypes.c_float(_qconst(width // heads, qkv.dtype)), int(fp32),
                                stream)
    check("fused_attention_qkv", rc)
    return out


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


# ---------------------------------------------------------------------------
# Public wrappers (JAX signatures)
# ---------------------------------------------------------------------------


@counted
def fused_attention_qkv(qkv: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                        heads: int) -> torch.Tensor:
    """(B, S, 3W) packed [Q|K|V] -> (B, S, W) attention output, no transposes."""
    if not route("fused_attention_qkv", qkv):
        return fused_attention_qkv_ref(qkv, mask, heads)
    out = _fused_attention_qkv_cuda(qkv, mask, heads)
    fused_attention_qkv.launches += 1
    return out


@counted
def fused_ln_qkv_attention(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, mask=None, *,
                           heads: int, eps: float = 1e-5) -> torch.Tensor:
    """(B, S, W) -> (B, S, W): x + OutProj(Attention(QKV(LN(x))))."""
    if not route("fused_ln_qkv_attention", x):
        return fused_ln_qkv_attention_ref(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, mask,
                                          heads=heads, eps=eps)
    out = _fused_ln_qkv_attention_cuda(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, mask,
                                       heads, eps)
    fused_ln_qkv_attention.launches += 1
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
