"""Serving counters, gauges and latency quantiles exposed on GET /metrics —
the port of ``aiic_tpu.serve.metrics``, with the same names.

Thread-safe and dependency-free: images/sec, batch occupancy, queue depth,
failure counts, per-endpoint latency quantiles and the per-stage timings
(``stages``: decode, dispatch, fetch, ...) that the engine and the serving
layers record. One key the JAX package's /metrics lacks: the batch-size
histogram, ``batches_of_size_{n}_total``.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict

from aiic_tpu_torch.utils.profiling import LatencyHistogram, StageTimer


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        # Per-endpoint latency quantiles: the REST layer records each
        # request's wall time under its endpoint name.
        self._latency: Dict[str, LatencyHistogram] = defaultdict(LatencyHistogram)
        # batches resolved, by size: the batch-size histogram of /metrics
        self._batch_sizes: Dict[int, int] = defaultdict(int)
        self._start = time.time()
        # Per-stage wall time: the engine and the serving layers wrap their
        # stages with ``metrics.stages.stage(name)``.
        self.stages = StageTimer()

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe_latency(self, name: str, seconds: float) -> None:
        with self._lock:
            self._latency[name].record(seconds)

    def observe_batch(self, batch_size: int, max_batch: int, seconds: float) -> None:
        with self._lock:
            self._counters["images_total"] += batch_size
            self._counters["batches_total"] += 1
            self._counters["batch_seconds_total"] += seconds
            self._gauges["last_batch_size"] = batch_size
            self._gauges["last_batch_occupancy"] = batch_size / max(max_batch, 1)
            self._batch_sizes[batch_size] += 1

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            up = time.time() - self._start
            out = dict(self._counters)
            out.update(self._gauges)
            out["uptime_seconds"] = up
            if self._counters.get("batch_seconds_total"):
                out["images_per_sec_avg"] = (
                    self._counters["images_total"] / self._counters["batch_seconds_total"])
            for size, n in sorted(self._batch_sizes.items()):
                out[f"batches_of_size_{size}_total"] = n
            for name, h in self._latency.items():
                out[f"{name}_p50_ms"] = round(1e3 * h.quantile(0.50), 3)
                out[f"{name}_p95_ms"] = round(1e3 * h.quantile(0.95), 3)
                out[f"{name}_p99_ms"] = round(1e3 * h.quantile(0.99), 3)
                out[f"{name}_latency_count"] = h.n
            for name, s in self.stages.summary().items():
                out[f"stage_{name}_mean_ms"] = round(s["mean_ms"], 3)
                out[f"stage_{name}_p50_ms"] = round(s["p50_ms"], 3)
                out[f"stage_{name}_p95_ms"] = round(s["p95_ms"], 3)
                out[f"stage_{name}_p99_ms"] = round(s["p99_ms"], 3)
                out[f"stage_{name}_total_s"] = round(s["total_s"], 4)
                out[f"stage_{name}_count"] = s["count"]
            return out


GLOBAL_METRICS = Metrics()
