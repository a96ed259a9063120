"""Static-shape batching helpers — the port's own copy of
``aiic_tpu.utils.batching``, held to it by ``tests/test_torch_bridge.py``.

Request batches are padded to power-of-two buckets, so a serving process
sees at most log2(max_batch) + 1 batch shapes while padding wastes < 2x.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def bucket_size(n: int, max_batch: int) -> int:
    """Smallest power-of-two >= n, capped at max_batch."""
    if n <= 0:
        raise ValueError("empty batch")
    b = 1
    while b < n:
        b <<= 1
    return min(b, max(max_batch, n))


def pad_batch(batch: np.ndarray, size: int) -> Tuple[np.ndarray, int]:
    """Zero-pad the leading axis to ``size``; returns (padded, valid_count)."""
    n = batch.shape[0]
    if n == size:
        return batch, n
    if n > size:
        raise ValueError(f"batch {n} exceeds bucket {size}")
    pad = np.zeros((size - n,) + batch.shape[1:], dtype=batch.dtype)
    return np.concatenate([batch, pad], axis=0), n
