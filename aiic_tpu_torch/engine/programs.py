"""The inference programs — the port of ``aiic_tpu.engine.programs``.

One classify pass per batch: encode each image once, then the detector
rule and the per-category attribute top-k on the same features:

    pixels ─ encode_image ─ normalize ─┬─ detector softmax + masses + top-1
                                       └─ per-category masked softmax + top-k
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from aiic_tpu_torch.models.clip import encode_image, encode_text, normalize_features
from aiic_tpu_torch.models.config import CLIPConfig
from aiic_tpu_torch.ops.attention import no_tf32


def detect_logits(feats: torch.Tensor, det_text: torch.Tensor,
                  interior_count: int) -> Dict[str, torch.Tensor]:
    """Batched detector rule. feats (B, D) and det_text (K, D) L2-normalized."""
    no_tf32()
    sims = torch.softmax(100.0 * feats @ det_text.T, dim=-1)  # (B, K)
    top_conf, top_idx = torch.max(sims, dim=-1)
    return {
        "top_conf": top_conf,
        "top_idx": top_idx,
        "interior_mass": sims[:, :interior_count].sum(dim=-1),
        "non_interior_mass": sims[:, interior_count:].sum(dim=-1),
    }


def analyze_topk(feats: torch.Tensor, cat_text: torch.Tensor, cat_mask: torch.Tensor,
                 k: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-category attribute scoring. feats (B, D); cat_text (C, N, D)
    zero-padded; cat_mask (C, N) bool. Returns top-k (values, indices), each
    (B, C, k); padded slots score 0. Ties may come back in another order
    than ``lax.top_k``'s."""
    no_tf32()
    sims = torch.einsum("bd,cnd->bcn", feats, cat_text)
    sims = torch.where(cat_mask[None], 100.0 * sims, torch.tensor(float("-inf"), device=sims.device))
    probs = torch.softmax(sims, dim=-1)
    probs = torch.where(cat_mask[None], probs, torch.zeros((), device=probs.device))
    k = min(k, probs.shape[-1])
    vals, idx = torch.topk(probs, k, dim=-1)
    return vals, idx


def classify_batch(params: Dict[str, Any], pixels: torch.Tensor, det_text: torch.Tensor,
                   cat_text: torch.Tensor, cat_mask: torch.Tensor, *, config: CLIPConfig,
                   interior_count: int, dtype: torch.dtype,
                   topk: int = 5) -> Dict[str, torch.Tensor]:
    """Encode once, detect + analyze. ``pixels``: normalized float HWC,
    uint8 HWC (normalized here), or patch-major uint8 (B, N, 3·p·p)."""
    if pixels.dtype == torch.uint8 and pixels.dim() == 4:
        from aiic_tpu_torch.ops.preprocess import normalize_u8

        pixels = normalize_u8(pixels, dtype=dtype)
    feats = normalize_features(encode_image(params, pixels, config, dtype=dtype))
    out = detect_logits(feats, det_text, interior_count)
    out["topk_vals"], out["topk_idx"] = analyze_topk(feats, cat_text, cat_mask, k=topk)
    out["features"] = feats
    return out


def encode_texts_program(params: Dict[str, Any], tokens: torch.Tensor, *,
                         config: CLIPConfig, dtype: torch.dtype) -> torch.Tensor:
    """Normalized text features for a (N, ctx) token batch; run once when
    the engine is built, for the detector and category prompts."""
    return normalize_features(encode_text(params, tokens, config, dtype=dtype))
