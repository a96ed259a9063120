"""Spans and the device trace.

Spans are recorded by the benchmark's own files around its calls into each
layer of the program, from any thread: name, start and end on the host's
clock, kept in memory. The window's start is marked both on the host's
clock and in the trace (a ``record_function`` range), which lays the spans
beside the device's idle gaps on the trace's clock.

``Tracer`` runs ``torch.profiler`` over the traced run, CPU and CUDA
activity. It opens with spin kernels (the profiler can drop the first
kernel records of a trace) and reduces the trace to: device busy seconds
inside the window (the union of every device operation's interval, kernels
and copies), device seconds and launches by kernel name, the operations
that took most time, and the longest idle gaps by the host span beside
them.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

WINDOW = "bench:window"


class Spans:
    def __init__(self):
        self.records: List[Tuple[str, float, float]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.records.append((name, t0, t1))


def _clean(name: str) -> str:
    """A kernel's name, its namespaces dropped so that the template
    arguments (the GEMM stage's epilogue) fit in 64 characters."""
    for noise in ("void ", "aiic::(anonymous namespace)::", "at::native::", "(anonymous namespace)::"):
        name = name.replace(noise, "")
    return re.sub(r"[^A-Za-z0-9_.:]", "_", name)[:64]


class TraceSummary:
    def __init__(self, busy_s: float, window_s: float, kernels: Dict[str, Tuple[float, int]],
                 traced: Dict[str, Tuple[float, int]], gaps: Dict[str, float]):
        self.busy_s = busy_s
        self.window_s = window_s
        self.kernels = kernels  # kernel name -> (device seconds, launches) inside the window
        self.traced = traced  # the same over the whole trace
        self.gaps = gaps

    def device_s(self, needle: str) -> float:
        """Device seconds of the kernels whose names hold ``needle``, over
        the whole trace (every traced call's work, the drain included)."""
        return sum(s for name, (s, _) in self.traced.items() if needle in name)

    def launches(self, needle: str) -> int:
        return sum(n for name, (_, n) in self.traced.items() if needle in name)

    def breakdown(self) -> dict:
        ops = sorted(((_clean(k), s) for k, (s, _) in self.kernels.items()),
                     key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, s] for k, s in ops], "idle_gaps": [[k, s] for k, s in gaps]}


def _event_times(ev) -> Tuple[float, float]:
    """(start, end) of a kinetic event in seconds on the trace's clock."""
    if hasattr(ev, "start_ns"):
        start = ev.start_ns() * 1e-9
        return start, start + ev.duration_ns() * 1e-9
    start = ev.start_us() * 1e-6
    return start, start + ev.duration_us() * 1e-6


class Tracer:
    """``torch.profiler`` over a run; ``stop()`` then ``summary()``."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self.prof = None

    def start(self) -> None:
        if not self.enabled:
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        if self.device.type == "cuda":
            for _ in range(64):  # lead-in: records the profiler may drop
                torch.cuda._sleep(100_000)
            torch.cuda.synchronize(self.device)

    def stop(self) -> None:
        if self.prof is None:
            return
        import torch

        if self.device.type == "cuda":
            for _ in range(64):  # tail, likewise
                torch.cuda._sleep(100_000)
            torch.cuda.synchronize(self.device)
        self.prof.stop()

    def summary(self, spans: Spans, window_host_start: float) -> Optional[TraceSummary]:
        """The trace reduced; ``window_host_start`` is the host clock's
        reading where the window's marker opened."""
        if self.prof is None:
            return None
        from torch.autograd import DeviceType

        events = self.prof.profiler.kineto_results.events()
        window = None
        device: List[Tuple[float, float, str]] = []
        for ev in events:
            name = ev.name()
            if ev.device_type() == DeviceType.CPU:
                if name == WINDOW:
                    window = _event_times(ev)
            elif ev.device_type() == DeviceType.CUDA and not name.startswith("bench:"):
                # (a record_function range also appears on the device's
                # timeline, as an annotation: not an operation)
                t0, t1 = _event_times(ev)
                if t1 > t0:
                    device.append((t0, t1, name))
        if window is None:
            raise RuntimeError("the trace holds no window marker")
        w0, w1 = window
        shift = w0 - window_host_start
        host = [(t0 + shift, t1 + shift, name) for name, t0, t1 in spans.records]
        kernels: Dict[str, Tuple[float, int]] = {}
        traced: Dict[str, Tuple[float, int]] = {}
        inside = []
        for t0, t1, name in device:
            if "spin_kernel" in name:  # the lead-in and tail
                continue
            s, n = traced.get(name, (0.0, 0))
            traced[name] = (s + (t1 - t0), n + 1)
            a, b = max(t0, w0), min(t1, w1)
            if b > a:
                inside.append((a, b))
                s, n = kernels.get(name, (0.0, 0))
                kernels[name] = (s + (b - a), n + 1)
        inside.sort()
        busy, gaps_iv = 0.0, []
        cur0, cur1 = None, None
        last = w0
        for a, b in inside:
            if cur1 is None or a > cur1:
                if cur1 is not None:
                    busy += cur1 - cur0
                    last = cur1
                if a > last:
                    gaps_iv.append((last, a))
                cur0, cur1 = a, b
            else:
                cur1 = max(cur1, b)
        if cur1 is not None:
            busy += cur1 - cur0
            last = cur1
        if w1 > last:
            gaps_iv.append((last, w1))
        gaps = self._attribute(gaps_iv, host)
        return TraceSummary(busy, w1 - w0, kernels, traced, gaps)

    @staticmethod
    def _attribute(gaps_iv, spans) -> Dict[str, float]:
        """Each idle gap's seconds go to the host spans beside it, the
        innermost (shortest) span first; what no span covers goes to
        ``host_outside_the_harness_spans``."""
        spans = sorted(spans)
        starts = [s[0] for s in spans]
        longest = max((s[1] - s[0] for s in spans), default=0.0)
        out: Dict[str, float] = {}
        for g0, g1 in gaps_iv:
            lo = bisect.bisect_left(starts, g0 - longest)
            hi = bisect.bisect_right(starts, g1)
            near = sorted((s for s in spans[lo:hi] if s[1] > g0), key=lambda s: s[1] - s[0])
            rest = [(g0, g1)]
            for s0, s1, name in near:
                if not rest:
                    break
                nxt = []
                for a, b in rest:
                    lo_, hi_ = max(a, s0), min(b, s1)
                    if hi_ > lo_:
                        out[name] = out.get(name, 0.0) + (hi_ - lo_)
                        if lo_ > a:
                            nxt.append((a, lo_))
                        if b > hi_:
                            nxt.append((hi_, b))
                    else:
                        nxt.append((a, b))
                rest = nxt
            left = sum(b - a for a, b in rest)
            if left > 0:
                out["host_outside_the_harness_spans"] = (
                    out.get("host_outside_the_harness_spans", 0.0) + left)
        return out
