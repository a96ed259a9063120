"""Attention helpers — the port of the pieces of ``aiic_tpu.ops.attention``
that the serving slice uses.

- ``exp2_rows`` / ``_denom_guard``: the clamped no-max softmax in the log2
  domain that the int8 attention kernel runs (``scale·log2(e)`` is folded
  into Q before Q·Kᵀ; the denominator divides once after p·V).
- ``attention_qkv_ref``: the reference stable-softmax composition on a fused
  (B, S, 3W) projection (``_attention_qkv_xla``), used by the fp path.
"""

from __future__ import annotations

from typing import Optional

import torch

# Clamped no-max softmax in the log2 domain: e^70 numerators keep the
# unnormalized fp32 p@v accumulation bounded (197 · e^70 · |v| ≪ fp32 max).
LOG2E = 1.4426950408889634
_EXP2_CLAMP = 70.0 * LOG2E


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


def attention_qkv_ref(qkv: torch.Tensor, mask: Optional[torch.Tensor],
                      heads: int) -> torch.Tensor:
    """Softmax attention on a fused (B, S, 3W) [Q|K|V] projection; products
    accumulate in fp32, the softmax is the stable one, probabilities are
    cast to the compute dtype before p·V."""
    no_tf32()
    bsz, seq, w3 = qkv.shape
    width = w3 // 3
    dim = width // heads
    q = qkv[..., :width].reshape(bsz, seq, heads, dim)
    k = qkv[..., width:2 * width].reshape(bsz, seq, heads, dim)
    v = qkv[..., 2 * width:].reshape(bsz, seq, heads, dim)
    scale = dim ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(qkv.dtype).reshape(bsz, seq, width)
