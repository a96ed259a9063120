"""Dynamic request batching — the port of ``aiic_tpu.serve.batcher``.

Coalesces concurrent requests into padded power-of-two buckets, so the card
sees large batches while each request's wait stays bounded by
``max_wait_ms``. A single collector thread drains a queue; a batch closes
when it reaches ``max_batch`` or the oldest request has waited
``max_wait_ms``. Results fan back out through per-request futures.

Pipelined mode (``fetch_batch`` given): ``run_batch`` only dispatches the
device program and returns a handle; a completer thread fetches results for
up to ``pipeline_depth`` in-flight batches while the collector dispatches
the next one, so host batch assembly and result copies overlap device
compute.

The count of dispatched-but-unresolved batches (``_inflight``) is changed
under a lock: the collector adds and the completer subtracts from two
threads (the JAX package's copy does both without one).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, List, Optional, Sequence

import numpy as np


class BatcherOverloaded(RuntimeError):
    """Raised by submit() when the admission-control queue bound is hit.

    The REST layer maps this to 503 + Retry-After: under sustained overload
    fast-failing new arrivals beats queueing work that is guaranteed to
    exceed its deadline anyway (and beats unbounded queue memory growth)."""


class DynamicBatcher:
    def __init__(
        self,
        run_batch: Callable[[np.ndarray], Any],
        *,
        max_batch: int = 64,
        max_wait_ms: float = 10.0,
        metrics=None,
        batch_timeout_s: float | None = None,
        on_timeout: Callable[[int], None] | None = None,
        max_queue: int | None = None,
        fetch_batch: Optional[Callable[[Any], Sequence[Any]]] = None,
        pipeline_depth: int = 2,
    ):
        """``batch_timeout_s``: hard deadline per dispatched batch. A batch
        that exceeds it fails its requests with TimeoutError and the collector
        moves on to the next batch instead of wedging the whole server behind
        one hung dispatch (the abandoned dispatch thread is daemonic and
        eventually dies with its computation; its late results land on
        already-failed futures, a no-op). ``on_timeout(n_items)`` is the
        dead-letter hook.

        ``max_queue``: admission-control bound on queued (undispatched)
        requests; when full, submit() raises BatcherOverloaded instead of
        enqueueing. None = unbounded (library default; the serving CLI sets
        a bound).

        ``fetch_batch``: enables pipelined mode — ``run_batch(items)``
        dispatches and returns a handle, ``fetch_batch(handle)`` blocks for
        and returns the per-item results. At most ``pipeline_depth``
        dispatched-but-unfetched batches stay in flight (the collector blocks
        past that — backpressure into the admission queue)."""
        self._run_batch = run_batch
        self._fetch_batch = fetch_batch
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.batch_timeout = batch_timeout_s
        self._on_timeout = on_timeout
        self.max_queue = max_queue
        self.pipeline_depth = max(1, pipeline_depth)
        if metrics is None:
            from aiic_tpu_torch.serve.metrics import GLOBAL_METRICS

            metrics = GLOBAL_METRICS
        self.metrics = metrics
        self._q: "queue.Queue" = queue.Queue()
        self._admit_lock = threading.Lock()
        self._stop = threading.Event()
        self._completions: Optional["queue.Queue"] = None
        self._completer: Optional[threading.Thread] = None
        # dispatched-but-unresolved batches: the collector adds, the
        # completer subtracts
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        if fetch_batch is not None:
            self._completions = queue.Queue(maxsize=max(1, pipeline_depth))
            self._completer = threading.Thread(target=self._complete_loop, daemon=True)
            self._completer.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, item: np.ndarray) -> Future:
        fut: Future = Future()
        if self.max_queue is not None:
            # check-and-put under a lock so concurrent handler threads
            # cannot all pass the qsize check and overshoot the bound
            with self._admit_lock:
                if self._q.qsize() >= self.max_queue:
                    self.metrics.inc("requests_rejected_total")
                    raise BatcherOverloaded(
                        f"request queue full ({self.max_queue}); retry later"
                    )
                self._q.put((item, fut))
        else:
            self._q.put((item, fut))
        return fut

    def __call__(self, item: np.ndarray) -> Any:
        return self.submit(item).result()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        if self._completer is not None:
            self._completer.join(timeout=2.0)

    # ------------------------------------------------------------------

    def _collect(self) -> List:
        """Block for the first item, then greedily take more until the batch
        is full or max_wait has elapsed since the first item arrived."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                # Pipelined mode, device still busy: an under-full batch
                # closed now could not start any sooner than the in-flight
                # work completes, so closing early only fragments the load
                # into small batches, each paying its own dispatch and
                # bucket padding. Keep collecting until a pipeline slot
                # frees or the batch fills; waiting for a free slot (not a
                # full drain) keeps the dispatch/fetch overlap.
                if (self._completions is not None
                        and self._inflight >= self.pipeline_depth
                        and not self._stop.is_set()):
                    # blocking 20 ms waits, not a tight poll that would
                    # compete for the interpreter lock with the completer
                    try:
                        batch.append(self._q.get(timeout=0.02))
                    except queue.Empty:
                        pass
                    continue
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _resolve(self, futures: List[Future], results: Sequence[Any]) -> None:
        for fut, res in zip(futures, results):
            # A client can cancel() between the done() check and set_result;
            # swallowing the InvalidStateError per-future keeps one racing
            # cancel from failing the whole batch.
            if not fut.done():
                try:
                    fut.set_result(res)
                except InvalidStateError:
                    pass

    def _fail(self, futures: List[Future], e: Exception) -> None:
        if isinstance(e, TimeoutError):
            self.metrics.inc("batch_timeouts_total")
            if self._on_timeout is not None:
                try:
                    self._on_timeout(len(futures))
                except Exception:
                    pass
        else:
            self.metrics.inc("batch_errors_total")
        for fut in futures:
            if not fut.done():
                try:
                    fut.set_exception(e)
                except InvalidStateError:
                    pass

    def _loop(self):
        while not self._stop.is_set():
            batch = self._collect()
            # Clients whose wait expired cancel their futures; computing
            # their results would be pure waste (discarded on arrival) and
            # under sustained overload turns into a death spiral where the
            # device does 100% of the work for 0% of the responses.
            batch = [b for b in batch if not b[1].cancelled()]
            if not batch:
                continue
            self.metrics.gauge("queue_depth", self._q.qsize())
            items = np.stack([b[0] for b in batch])
            futures = [b[1] for b in batch]
            t0 = time.perf_counter()
            if self._completions is not None:
                # pipelined: dispatch here, resolve in the completer thread.
                # The dispatch half gets the same hard deadline as the fetch
                # half — a hung dispatch (a stalled device or a first build)
                # otherwise wedges the collector forever and every queued
                # request behind it, violating batch_timeout's no-wedge
                # contract.
                try:
                    if self.batch_timeout is None:
                        handle = self._run_batch(items)
                    else:
                        handle = self._with_deadline(
                            lambda: self._run_batch(items), len(futures))
                except Exception as e:
                    self._fail(futures, e)
                    continue
                with self._inflight_lock:
                    self._inflight += 1
                # blocks when pipeline_depth batches are already in flight
                self._completions.put((handle, futures, t0))
                continue
            try:
                if self.batch_timeout is None:
                    results = self._run_batch(items)
                else:
                    results = self._with_deadline(
                        lambda: self._run_batch(items), len(futures))
                self._resolve(futures, results)
                self.metrics.observe_batch(len(batch), self.max_batch, time.perf_counter() - t0)
            except Exception as e:
                self._fail(futures, e)

    def _complete_loop(self):
        """Pipelined mode's second stage: fetch results for dispatched
        batches in dispatch order and fan them out."""
        assert self._completions is not None
        while True:
            try:
                handle, futures, t0 = self._completions.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                if self.batch_timeout is None:
                    results = self._fetch_batch(handle)
                else:
                    results = self._with_deadline(
                        lambda: self._fetch_batch(handle), len(futures))
                self._resolve(futures, results)
                self.metrics.observe_batch(
                    len(futures), self.max_batch, time.perf_counter() - t0)
            except Exception as e:
                self._fail(futures, e)
            finally:
                with self._inflight_lock:
                    self._inflight -= 1

    def _with_deadline(self, call: Callable[[], Sequence[Any]], n: int):
        """Run ``call`` on a fresh daemon thread, wait at most batch_timeout."""
        box: dict = {}

        def work():
            try:
                box["results"] = call()
            except Exception as e:  # propagate real errors, not just timeouts
                box["error"] = e

        t = threading.Thread(target=work, daemon=True)
        t.start()
        t.join(self.batch_timeout)
        if t.is_alive():
            raise TimeoutError(
                f"batch of {n} exceeded {self.batch_timeout}s deadline"
            )
        if "error" in box:
            raise box["error"]
        return box["results"]
