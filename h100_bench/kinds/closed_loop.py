"""``closed_loop``: single crops submitted to ``serve.batcher.DynamicBatcher``
over the worker's ``make_run_batch``, ``outstanding`` requests in flight.
A future's callback records the answer and frees its slot; one client
thread submits the replacements, so the batcher's completer thread resolves
a batch without submitting for it.

Each answer dict carries the engine's features of its own row from the
moment the worker's ``fetch_batch`` returns it, so the features reach the
request along the answer's own route through the batcher; the comparison
judges them against the reference on the request's own crop.

The window runs from one batch's resolution to the first resolved at or
after its seconds, and counts the requests of the batches between, each
timed from its submission to its future's callback.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Dict, List

import numpy as np

from h100_bench import check
from h100_bench import generator as g
from h100_bench import weights as inputs

FEATURES = "_features"


class Runner:
    def __init__(self, ctx: g.Context):
        self.ctx = ctx
        self.t = ctx.traffic

    def setup(self) -> None:
        from aiic_tpu_torch.serve.app import make_run_batch
        from aiic_tpu_torch.serve.batcher import DynamicBatcher

        ctx, t = self.ctx, self.t
        with ctx.spans("setup.engine"):
            self.analyzer = g.analyzer(ctx, t["max_batch"])
        with ctx.spans("setup.inputs"):
            crops = inputs.make_crops(t["pool"], ctx.cfg["image_size"], ctx.seed, ctx.device)
            self.crops = crops[g.pool_rows(ctx, len(crops))]
        sizes, b = [], 1
        while b <= t["max_batch"]:
            sizes.append(b)
            b *= 2
        with ctx.spans("setup.warmup"):
            self.analyzer.warmup(sizes)
            g.sync(ctx.device)
        run_batch, fetch_batch = make_run_batch(self.analyzer, t["confidence"], t["max_batch"],
                                                t["pipeline_depth"])
        engine_fetch = self.analyzer.fetch_results

        def fetch_results(pending):  # the worker's fetch, the engine's arrays kept
            res = engine_fetch(pending)
            self.raw = res["features"]
            return res

        self.analyzer.fetch_results = fetch_results
        spans = ctx.spans
        self.lock = threading.Lock()
        self.freed = threading.Condition(self.lock)  # the client waits for free slots
        self.resolved = threading.Condition(self.lock)  # the main thread waits for batches
        self.batches: List[float] = []  # when each batch's last future resolved
        self.dispatched: List[int] = []  # the rows of each dispatch, in order
        self.current = 0  # futures of the fetched batch still to resolve
        self.records: List[tuple] = []  # (request, submitted, done, batch index, ok)
        self.results: Dict[int, Any] = {}
        self.next_id = 0
        self.running = True
        self.refused = 0
        self.to_submit = t["outstanding"]

        def run(items):
            with spans("batcher.dispatch"):
                handle = run_batch(items)
            self.dispatched.append(len(items))
            return handle

        def fetch(handle):
            with spans("batcher.fetch"):
                res = fetch_batch(handle)
            for i, answer in enumerate(res):  # the row's features ride with its answer
                answer[FEATURES] = self.raw[i]
            with self.lock:  # this batch's futures resolve next, on this thread
                self.current = len(res)
            return res

        self.batcher = DynamicBatcher(run, max_batch=t["max_batch"], max_wait_ms=t["max_wait_ms"],
                                      metrics=self.analyzer.metrics, max_queue=t["max_queue"],
                                      fetch_batch=fetch, pipeline_depth=t["pipeline_depth"])
        self.client = threading.Thread(target=self._client, name="closed-loop-client",
                                       daemon=True)
        self.client.start()
        # ramp to the steady state: every pipeline slot full, then some
        with ctx.spans("setup.ramp"):
            self._wait_batches(2 * (t["pipeline_depth"] + 1) + 2, timeout=120.0)

    def _client(self) -> None:
        """Submit a request for every free slot until the window closes."""
        while True:
            with self.lock:
                self.freed.wait_for(lambda: self.to_submit or not self.running)
                if not self.running:
                    return
                n, self.to_submit = self.to_submit, 0
            for _ in range(n):
                self._submit()

    def _submit(self) -> None:
        from aiic_tpu_torch.serve.batcher import BatcherOverloaded

        with self.lock:
            rid = self.next_id
            self.next_id += 1
        crop = self.crops[rid % len(self.crops)]
        t_sub = time.perf_counter()
        try:
            fut = self.batcher.submit(crop)
        except BatcherOverloaded:
            with self.lock:
                self.refused += 1
                self.records.append((rid, t_sub, t_sub, -1, False))
            return
        fut.add_done_callback(functools.partial(self._done, rid=rid, t_sub=t_sub))

    def _done(self, fut, rid: int, t_sub: float) -> None:
        t = time.perf_counter()
        ok = fut.exception() is None
        with self.lock:
            idx = -1
            if ok and self.current:
                idx = len(self.batches)
                self.current -= 1
                if self.current == 0:
                    self.batches.append(t)
                    self.resolved.notify_all()
            self.records.append((rid, t_sub, t, idx, ok))
            if ok:
                self.results[rid] = fut.result()
            if self.running:
                self.to_submit += 1
                if self.to_submit == 1:
                    self.freed.notify()

    def _wait_batches(self, n: int, timeout: float) -> None:
        """Block until ``n`` batches have resolved."""
        with self.lock:
            if not self.resolved.wait_for(lambda: len(self.batches) >= n, timeout):
                raise RuntimeError(f"closed loop: {len(self.batches)} of {n} batches "
                                   f"in {timeout} s")

    def window(self, seconds: float, marker) -> Dict[str, Any]:
        m = self.analyzer.metrics
        with self.lock:
            i0 = len(self.batches)
            self.traced_from = len(self.dispatched)
        marker.start()
        self._wait_batches(i0 + 1, timeout=60.0)
        t0 = self.batches[i0]
        snap0 = (m.snapshot(), g.stage_totals(m, "dispatch"))
        with self.lock:
            if not self.resolved.wait_for(lambda: self.batches[-1] >= t0 + seconds,
                                          seconds + 60.0):
                raise RuntimeError(f"closed loop: no batch resolved past {seconds} s")
            i1 = len(self.batches) - 1
        snap1 = (m.snapshot(), g.stage_totals(m, "dispatch"))
        marker.end()
        t_end = self.batches[i1]
        with self.lock:
            self.running = False
            self.freed.notify()
            inside = [r for r in self.records
                      if i0 < r[3] <= i1 or (not r[4] and t0 < r[2] <= t_end)]
        self.inside = inside
        done = [r for r in inside if r[4]]
        lat = sorted(r[2] - r[1] for r in done)
        c0, c1 = snap0[0], snap1[0]
        return {"window_s": t_end - t0, "attempted": len(inside),
                "failed": len(inside) - len(done),
                "e2e": {"served_per_s": len(done) / (t_end - t0),
                        "p95_ms": 1e3 * g.quantile(lat, 0.95)},
                "counters": {"images_total": c1.get("images_total", 0) - c0.get("images_total", 0),
                             "batches_total": c1.get("batches_total", 0) - c0.get("batches_total", 0),
                             "dispatch_count": snap1[1][0] - snap0[1][0],
                             "dispatch_s": snap1[1][1] - snap0[1][1],
                             "max_batch": self.t["max_batch"], "refused": self.refused,
                             "interior_answers": sum(
                                 self.results[r[0]]["detected_category"] == "interior"
                                 for r in done)},
                "images": len(done)}

    def finish(self) -> Dict[str, Any]:
        """Every request still in flight answered, the client and the batcher
        stopped; the buckets dispatched since the trace began."""
        self.client.join(timeout=60.0)
        end = time.perf_counter() + 90.0
        while True:
            with self.lock:
                unsettled = self.next_id - len(self.records)
            if not unsettled:
                break
            if time.perf_counter() > end:
                raise RuntimeError(f"closed loop: {unsettled} requests never answered")
            time.sleep(0.005)
        self.batcher.close()
        return {"traced_calls": [g.bucket(n) for n in self.dispatched[self.traced_from:]]}

    def compare(self, control) -> Dict[str, float]:
        """The features each sampled request received with its answer, against
        the reference's of the request's own crop."""
        ctx = self.ctx
        done = [r[0] for r in self.inside if r[4]]
        n = ctx.traffic.get("check_rows", 0)
        pick = ctx.rng(2).choice(len(done), size=min(n, len(done)), replace=False)
        rids = [done[p] for p in sorted(pick)]
        crops = np.stack([self.crops[r % len(self.crops)] for r in rids])
        features = np.stack([self.results[r][FEATURES] for r in rids])
        del self.batcher, self.analyzer
        g.release(ctx.device)
        ref = check.reference_answers(ctx.cfg, ctx.seed, crops, ctx.device)
        if control == "reference":
            features = check.reference_answers(ctx.cfg, ctx.seed, crops, ctx.device,
                                               ctx.cfg["control"]["reference"])["features"]
            features = features.cpu().numpy()  # in the form the program's answers carry
        return check.feature_numbers(ref, features)
