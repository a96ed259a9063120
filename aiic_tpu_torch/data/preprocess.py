"""CLIP image preprocessing — copied from ``aiic_tpu.data.preprocess``.

The reference preprocess is the torchvision pipeline of ``clip.load``
(main.py:201, main.py:438, train_lora.py:149): Resize(shorter side -> 224,
bicubic) -> CenterCrop(224) -> ToTensor -> Normalize(CLIP mean/std).
``preprocess_pil`` runs it with PIL (the resample torchvision calls);
``resize_matrix`` / ``resize_bicubic_numpy`` are PIL's separable bicubic as
dense matrices, fixed-point weight quantization included, and
``preprocess_numpy`` / ``preprocess_numpy_batch`` the whole pipeline on them
(uint8 arrays in, normalized float32 out). The trainer's
``PromptedImageDataset`` feeds its images through ``preprocess_pil``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

_PRECISION_BITS = 32 - 8 - 2  # PIL's fixed-point precision for uint8 resampling


def _bicubic_filter(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """PIL's bicubic kernel (a = -0.5), vectorized."""
    x = np.abs(x)
    out = np.zeros_like(x)
    m1 = x < 1
    m2 = (x >= 1) & (x < 2)
    out[m1] = ((a + 2) * x[m1] - (a + 3)) * x[m1] * x[m1] + 1
    out[m2] = (((x[m2] - 5) * x[m2] + 8) * x[m2] - 4) * a
    return out


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int, quantize: bool = True) -> np.ndarray:
    """(out_size, in_size) PIL-exact bicubic resampling matrix for one axis."""
    support_base = 2.0
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support_base * filterscale
    k = np.zeros((out_size, in_size), dtype=np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        idx = np.arange(xmin, xmax)
        w = _bicubic_filter((idx - center + 0.5) / filterscale)
        w = w / w.sum()
        if quantize:
            # PIL quantizes weights to signed fixed point for uint8 images.
            w = np.round(w * (1 << _PRECISION_BITS)) / (1 << _PRECISION_BITS)
        k[xx, xmin:xmax] = w
    return k.astype(np.float32)


def resize_target(w: int, h: int, size: int) -> Tuple[int, int]:
    """torchvision Resize(size) semantics: shorter side -> size, keep aspect.

    torchvision computes the long side as ``int(size * long / short)`` —
    truncation, NOT rounding (torchvision/transforms/functional.py,
    ``_compute_resized_output_size``). E.g. 640x480 -> 298x224, where
    rounding would give 299x224 and shift the center crop by a pixel.
    """
    if w <= h:
        return size, max(size, int(size * h / w))
    return max(size, int(size * w / h)), size


def _clip8(x: np.ndarray) -> np.ndarray:
    """PIL's round-half-up + clamp to uint8 after a resample pass."""
    return np.clip(np.floor(x + 0.5), 0, 255).astype(np.float32)


def resize_bicubic_numpy(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """uint8 HWC -> float32 HWC, PIL two-pass (horizontal, then vertical)."""
    h, w = img.shape[:2]
    kx = resize_matrix(w, out_w)
    ky = resize_matrix(h, out_h)
    x = img.astype(np.float32)
    x = _clip8(np.einsum("hwc,ow->hoc", x, kx))  # horizontal pass
    x = _clip8(np.einsum("hwc,oh->owc", x, ky))  # vertical pass (contracts h)
    return x


def center_crop_bounds(w: int, h: int, size: int) -> Tuple[int, int]:
    """torchvision CenterCrop coordinates (top, left)."""
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return top, left


def preprocess_pil_u8(img, size: int = 224) -> np.ndarray:
    """PIL image -> uint8 (size, size, 3) resize+crop, reference-exact.

    The pixel pipeline of :func:`preprocess_pil` WITHOUT the final
    normalization — the form device-side normalize paths consume (the uint8
    wire formats fold normalization into the device program).
    """
    from PIL import Image

    if img.mode != "RGB":
        img = img.convert("RGB")
    w, h = img.size
    new_w, new_h = resize_target(w, h, size)
    img = img.resize((new_w, new_h), Image.BICUBIC)
    top, left = center_crop_bounds(new_w, new_h, size)
    # Handle images whose resized long side is below the crop (pad like torchvision).
    arr = np.asarray(img, dtype=np.uint8)
    if top < 0 or left < 0:
        pad_h = max(0, -top)
        pad_w = max(0, -left)
        arr = np.pad(arr, ((pad_h, pad_h), (pad_w, pad_w), (0, 0)))
        top += pad_h
        left += pad_w
    return arr[top : top + size, left : left + size]


def preprocess_pil(img, size: int = 224) -> np.ndarray:
    """PIL image -> normalized float32 (size, size, 3), reference-exact.

    Mirrors the torchvision Compose returned by ``clip.load``; PIL performs
    the identical bicubic resample the reference goes through.
    """
    arr = preprocess_pil_u8(img, size)
    return ((arr.astype(np.float32) / 255.0) - CLIP_MEAN) / CLIP_STD


def preprocess_numpy(img: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 HWC array -> normalized float32 (size, size, 3) using the
    matrix-resample path (same math the device kernel runs)."""
    h, w = img.shape[:2]
    new_w, new_h = resize_target(w, h, size)
    resized = resize_bicubic_numpy(img, new_w, new_h)
    top, left = center_crop_bounds(new_w, new_h, size)
    crop = resized[max(top, 0) : max(top, 0) + size, max(left, 0) : max(left, 0) + size]
    return ((crop / 255.0) - CLIP_MEAN) / CLIP_STD


def preprocess_numpy_batch(imgs, size: int = 224) -> np.ndarray:
    """List of uint8 HWC arrays (any sizes) -> (N, size, size, 3) float32."""
    return np.stack([preprocess_numpy(np.asarray(im), size) for im in imgs])
