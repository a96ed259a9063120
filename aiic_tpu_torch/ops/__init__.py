"""Compute ops of the port: attention helpers, preprocessing, int8 kernels
(``aiic_tpu.ops``'s names at the package level)."""

from aiic_tpu_torch.ops.preprocess import (
    device_preprocess_fixed,
    make_resize_mats,
    normalize_u8,
)

__all__ = ["normalize_u8", "device_preprocess_fixed", "make_resize_mats"]
