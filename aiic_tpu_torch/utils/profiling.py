"""Per-stage timing and device traces — the port of ``aiic_tpu.utils.profiling``.

``LatencyHistogram`` and ``StageTimer`` are copies (no JAX in them);
``device_trace`` records a ``torch.profiler`` trace where the JAX package
records a ``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from collections import defaultdict
from typing import Dict, Optional


class LatencyHistogram:
    """Streaming log-bucketed latency histogram: O(1) record, fixed memory,
    bounded relative quantile error (bucket ratio 1.15, at most ~7%).

    NOT thread-safe on its own; callers serialize under their own lock
    (StageTimer and Metrics both do)."""

    _MIN = 5e-5          # 50 µs floor; everything below lands in bucket 0
    _RATIO = 1.15
    _LOG_RATIO = math.log(_RATIO)
    _N = 110             # covers up to _MIN * 1.15^110 ≈ 260 s

    def __init__(self):
        self.counts = [0] * (self._N + 1)
        self.n = 0

    def record(self, seconds: float) -> None:
        if seconds <= self._MIN:
            i = 0
        else:
            i = min(int(math.log(seconds / self._MIN) / self._LOG_RATIO) + 1, self._N)
        self.counts[i] += 1
        self.n += 1

    def quantile(self, q: float) -> float:
        """Approximate q-quantile in seconds (geometric bucket midpoint)."""
        if not self.n:
            return 0.0
        target = q * (self.n - 1)
        seen = 0
        for i, cnt in enumerate(self.counts):
            seen += cnt
            if cnt and seen > target:
                lo = self._MIN * self._RATIO ** (i - 1) if i else 0.0
                hi = self._MIN * self._RATIO ** i
                return (lo + hi) / 2.0
        return self._MIN * self._RATIO ** self._N


class StageTimer:
    """Wall time per named stage. Thread-safe: serving handler threads
    record stages concurrently with GET /metrics snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.hists: Dict[str, LatencyHistogram] = defaultdict(LatencyHistogram)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, dt: float) -> None:
        """One span of ``dt`` seconds of stage ``name`` (a span that starts
        and ends in different calls)."""
        with self._lock:
            self.totals[name] += dt
            self.counts[name] += 1
            self.hists[name].record(dt)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1),
                    "p50_ms": 1e3 * self.hists[k].quantile(0.50),
                    "p95_ms": 1e3 * self.hists[k].quantile(0.95),
                    "p99_ms": 1e3 * self.hists[k].quantile(0.99)}
                for k in self.totals
            }


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """``torch.profiler`` trace of the block (CPU, and CUDA where a card is
    present) written to ``logdir`` in the TensorBoard layout; no-op when
    ``logdir`` is None."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
