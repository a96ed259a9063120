"""``offline``: host uint8 crops from a seeded pool in calls of ``batch``
through ``InteriorAnalyzer.dispatch_pixels`` / ``fetch_results``, with
``ahead`` calls dispatched before the oldest is fetched. The window ends at
the first fetched call at or after its seconds."""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List

import numpy as np

from h100_bench import check
from h100_bench import generator as g
from h100_bench import weights as inputs


class Runner:
    def __init__(self, ctx: g.Context):
        self.ctx = ctx
        t = ctx.traffic
        self.batch, self.ahead = t["batch"], t["ahead"]

    def setup(self) -> None:
        ctx = self.ctx
        with ctx.spans("setup.engine"):
            self.analyzer = g.analyzer(ctx, self.batch)
        with ctx.spans("setup.inputs"):
            crops = inputs.make_crops(ctx.traffic["pool"], ctx.cfg["image_size"], ctx.seed,
                                      ctx.device)
            self.crops = crops[g.pool_rows(ctx, len(crops))]  # every call a contiguous slice
            self.n_calls = len(self.crops) // self.batch
        with ctx.spans("setup.warmup"):
            self.analyzer.warmup([self.batch])
            for i in range(2):
                self.analyzer.fetch_results(self.analyzer.dispatch_pixels(self._call(i)))
            g.sync(ctx.device)

    def _call(self, i: int) -> np.ndarray:
        j = i % self.n_calls
        return self.crops[j * self.batch:(j + 1) * self.batch]

    def window(self, seconds: float, marker) -> Dict[str, Any]:
        spans, a = self.ctx.spans, self.analyzer
        d0 = g.stage_totals(a.metrics, "dispatch")
        pending = collections.deque()
        self.outputs: List[tuple] = []
        calls = []
        marker.start()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while True:
            while len(pending) <= self.ahead:
                with spans("engine.dispatch"):
                    pending.append((i, a.dispatch_pixels(self._call(i))))
                calls.append(self.batch)
                i += 1
            j, handle = pending.popleft()
            with spans("engine.fetch"):
                res = a.fetch_results(handle)
            self.outputs.append((j, res))
            t_end = time.perf_counter()
            if t_end >= deadline:
                break
        marker.end()
        d1 = g.stage_totals(a.metrics, "dispatch")
        self.pending = pending
        done = len(self.outputs) * self.batch
        failed = sum(int((~np.isfinite(r["features"])).any(axis=-1).sum()) for _, r in self.outputs)
        return {"window_s": t_end - t0, "attempted": done, "failed": failed,
                "e2e": {"images_per_s": done / (t_end - t0)},
                "counters": {"dispatch_count": d1[0] - d0[0], "dispatch_s": d1[1] - d0[1]},
                "traced_calls": calls, "images": done}

    def finish(self) -> None:
        """The calls dispatched ahead of the window's end: fetched, not counted."""
        for _, handle in self.pending:
            self.analyzer.fetch_results(handle)

    def sample(self, n: int):
        """(crops (n, H, W, 3) uint8, program outputs of those rows) drawn
        from the seed among the window's answers."""
        rows = [(k, r) for k in range(len(self.outputs)) for r in range(self.batch)]
        pick = self.ctx.rng(2).choice(len(rows), size=min(n, len(rows)), replace=False)
        crops, outs = [], collections.defaultdict(list)
        for p in sorted(pick):
            k, r = rows[p]
            j, res = self.outputs[k]
            crops.append(self._call(j)[r])
            for key, v in res.items():
                outs[key].append(v[r])
        return np.stack(crops), {key: np.stack(v) for key, v in outs.items()}

    def compare(self, control) -> Dict[str, float]:
        ctx = self.ctx
        crops, prog = self.sample(ctx.traffic.get("check_rows", 0))
        del self.analyzer
        g.release(ctx.device)
        ref = check.reference_answers(ctx.cfg, ctx.seed, crops, ctx.device)
        if control == "reference":
            prog = check.as_program(check.reference_answers(
                ctx.cfg, ctx.seed, crops, ctx.device, ctx.cfg["control"]["reference"]))
        return check.offline_numbers(ref, prog)
