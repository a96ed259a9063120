"""Preprocessing for the serving wire — the port of ``aiic_tpu.ops.preprocess``.

The serving wire is patch-major uint8 (B, N, 3·p·p): normalization folds
into the embed weight (``patch_norm_constants``), and under int8 serving the
folded weight itself is quantized (``quantize_patch_embed``), so the embed
is one integer product straight from the uint8 patches.

The device-resize path (``make_resize_mats``, ``device_preprocess_fixed``)
runs PIL's separable bicubic as two fp32 products on the device, with PIL's
round-half-up clip to uint8 levels after each pass, then crop and normalize.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from aiic_tpu_torch.data.preprocess import (
    CLIP_MEAN, CLIP_STD, center_crop_bounds, resize_matrix, resize_target,
)


def normalize_u8(pixels_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> normalized (B, H, W, 3) in ``dtype``."""
    mean = torch.as_tensor(CLIP_MEAN * 255.0, device=pixels_u8.device)
    inv = torch.as_tensor(1.0 / (CLIP_STD * 255.0), device=pixels_u8.device)
    return ((pixels_u8.float() - mean) * inv).to(dtype)


@functools.lru_cache(maxsize=8)
def patch_norm_constants(patch: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(s, ms)`` with ``s[k] = 1/(255·std[c])`` and ``ms[k] = 255·mean[c]·s[k]``
    for flat patch index ``k = c·p·p + py·p + px``, so that
    ``normalize(x) @ W == x @ (s[:, None]·W) - ms @ W``."""
    chan = np.arange(3 * patch * patch) // (patch * patch)
    s = (1.0 / (CLIP_STD * 255.0))[chan].astype(np.float32)
    ms = (CLIP_MEAN * 255.0)[chan].astype(np.float32) * s
    return s, ms


def quantize_patch_embed(w) -> Dict[str, torch.Tensor]:
    """int8 patch embed for the patch-major uint8 wire:

        normalize(x_u8) @ W == (x_s8 @ Wq) * wsc + c2
        W'  = s[:, None] * W;  Wq = round(W' / wsc), wsc[j] = max|W'[:, j]| / 127
        c2  = ((128 - 255·mean) * s) @ W

    with ``x_s8 = x_u8 ^ 0x80`` read as int8. An all-zero column gets
    ``wsc = 1``. Computed in numpy (as the JAX package does) and returned as
    tensors on ``w``'s device."""
    device = w.device if isinstance(w, torch.Tensor) else "cpu"
    w32 = (w.detach().float().cpu().numpy() if isinstance(w, torch.Tensor)
           else np.asarray(w, np.float32))
    k = w32.shape[0]
    chan = np.arange(k) // (k // 3)
    s = (1.0 / (CLIP_STD * 255.0))[chan].astype(np.float32)
    m = (CLIP_MEAN * 255.0)[chan].astype(np.float32)
    wf = w32 * s[:, None]
    wsc = np.abs(wf).max(axis=0) / 127.0
    wsc = np.where(wsc == 0.0, 1.0, wsc).astype(np.float32)
    wq = np.clip(np.round(wf / wsc), -127, 127).astype(np.int8)
    c2 = (((128.0 - m) * s) @ w32).astype(np.float32)
    return {"wq": torch.from_numpy(wq).to(device),
            "wsc": torch.from_numpy(wsc).to(device),
            "c2": torch.from_numpy(c2).to(device)}


def to_patch_major(pixels_u8: np.ndarray, patch: int) -> np.ndarray:
    """Host repack: uint8 (B, S, S, 3) -> (B, N, 3·p·p), channel-major within
    a patch (torch Conv2d (out, C, kh, kw) weight order)."""
    b, h, w, c = pixels_u8.shape
    gh, gw = h // patch, w // patch
    x = pixels_u8.reshape(b, gh, patch, gw, patch, c)
    x = x.transpose(0, 1, 3, 5, 2, 4)
    return np.ascontiguousarray(x.reshape(b, gh * gw, c * patch * patch))


@functools.lru_cache(maxsize=64)
def make_resize_mats(in_h: int, in_w: int, size: int = 224) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """(Ky, Kx, top, left) for resize-shorter-side + center-crop of a fixed
    input geometry. Ky: (new_h, in_h), Kx: (new_w, in_w)."""
    new_w, new_h = resize_target(in_w, in_h, size)
    ky = resize_matrix(in_h, new_h)
    kx = resize_matrix(in_w, new_w)
    top, left = center_crop_bounds(new_w, new_h, size)
    return ky, kx, max(top, 0), max(left, 0)


def device_preprocess_fixed(pixels_u8: torch.Tensor, ky: torch.Tensor, kx: torch.Tensor,
                            top: int, left: int, size: int = 224,
                            dtype=torch.float32) -> torch.Tensor:
    """uint8 (B, H, W, 3) of one fixed geometry -> normalized (B, size, size, 3)
    in ``dtype``: the horizontal pass, then the vertical one, each summed in
    fp32 (TF32 off) and clipped to ``floor(x + 0.5)`` in [0, 255] as PIL
    rounds between passes, then crop and normalize."""
    from aiic_tpu_torch.ops.attention import no_tf32

    no_tf32()
    x = pixels_u8.float()
    x = torch.einsum("bhwc,ow->bhoc", x, kx.float())  # horizontal: contract W
    x = torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)
    x = torch.einsum("bhwc,oh->bowc", x, ky.float())  # vertical: contract H
    x = torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)
    x = x[:, top:top + size, left:left + size]
    mean = torch.as_tensor(CLIP_MEAN * 255.0, device=x.device)
    inv = torch.as_tensor(1.0 / (CLIP_STD * 255.0), device=x.device)
    return ((x - mean) * inv).to(dtype)
