"""One ordered lane of engine calls across the ranks of a serving world.

On torch.distributed each device is a process, so an engine on a mesh
(``InteriorAnalyzer(mesh=...)``) needs every rank to make the same calls
with the same pixels: each rank classifies its slice of the bucket, and the
fetch gathers the rows. A server's requests reach one process. Rank 0 leads:
its HTTP server, batcher, warmup and queue drain call the engine through an
:class:`EngineLane`, which sends each call to the other ranks before it runs
it. The other ranks follow (:meth:`EngineLane.follow`): they make the same
call on what they receive and drop the host results.

Every call that issues a collective goes through the lane, in one order,
whatever thread makes it. Calls take their turn in the order they arrive (a
ticket each), so a call its caller has given up on (the batcher's deadline)
still runs in its place, and a later call never overtakes it. A command is a
fixed header (op, sequence number, ``max_batch``, the pixels' dtype and
shape, the warmup's buckets) broadcast over a gloo group of the lane's own,
then the pixels as one tensor. A fetch issues its gathers in its turn and
waits for them after it, so the next dispatch does not wait for the device.

An idle lane sends a heartbeat: a follower's wait for the next command stays
within the group's timeout, and a dead follower is found without a request.
A failed collective breaks the lane: every later call raises
:class:`LaneError`, and ``broken`` is set for the caller to stop serving.
``close()`` sends the stop command, and the followers' ``follow()`` returns.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DISPATCH, FETCH, WARMUP, HEARTBEAT, STOP = range(1, 6)
# The header: op, sequence number, max_batch (0: the engine's), the pixels'
# dtype (an index of DTYPES, -1: none) and rank, their shape, then the count
# of warmup buckets (-1: the engine's default) and the buckets.
HEADER = 32
MAX_RANK = 6
SHAPE_AT, SIZES_AT = 5, 5 + MAX_RANK
MAX_SIZES = HEADER - SIZES_AT - 1
DTYPES = ((np.uint8, torch.uint8), (np.float32, torch.float32))
# The lane group's timeout, and how long an idle lane waits for a heartbeat.
TIMEOUT_S = 120.0
HEARTBEAT_S = TIMEOUT_S / 4
# Fetches a follower leaves unwaited before it waits for the oldest.
FOLLOWER_DEPTH = 2


class LaneError(RuntimeError):
    """A call on a lane that a failed collective broke, or that was closed."""


@dataclass
class LaneHandle:
    """``EngineLane.dispatch_pixels``'s handle: the sequence number the
    followers know the dispatch by, and rank 0's own pending results."""

    seq: int
    pending: List[tuple]


class EngineLane:
    """The lane of one engine over the world (every rank builds one, after
    the engine: opening it is collective). Rank 0 calls the engine's
    serving surface on it; the others call :meth:`follow`. Any other
    attribute reads through to the engine."""

    # entry points that reach collectives but are not led through the lane
    _NOT_LED = frozenset({"analyze_pixels", "analyze_images_batch", "filter_interior_images",
                          "is_interior_image", "analyze_image_from_url"})

    def __init__(self, analyzer, *, log: Callable[[str], None] = print):
        self.analyzer = analyzer
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.group = dist.new_group(backend="gloo",
                                    timeout=datetime.timedelta(seconds=TIMEOUT_S))
        self.log = log
        self.error: Optional[BaseException] = None
        self.broken = threading.Event()
        self._cond = threading.Condition()
        self._tickets = 0    # handed out
        self._serving = 0    # the ticket whose turn it is
        self._seq = 0
        self._closed = False
        self._last_send = time.monotonic()
        self._stop_beat = threading.Event()
        if self.rank == 0 and self.world > 1:
            threading.Thread(target=self._beat, daemon=True, name="aiic-lane-heartbeat").start()

    def __getattr__(self, name: str) -> Any:
        if name == "analyzer":  # not set yet
            raise AttributeError(name)
        if name in self._NOT_LED:
            raise AttributeError(f"{name} is not led through the engine lane: rank 0 would "
                                 f"reach collectives that the other ranks never join")
        return getattr(self.analyzer, name)

    # ------------------------------------------------------------------
    # Rank 0: the engine's serving surface, each call sent first
    # ------------------------------------------------------------------

    def dispatch_pixels(self, pixels: np.ndarray, max_batch: Optional[int] = None) -> LaneHandle:
        pixels = np.ascontiguousarray(pixels)
        with self._turn():
            seq = self._seq
            self._seq += 1
            self._send(DISPATCH, seq, max_batch, pixels=pixels)
            return LaneHandle(seq, self.analyzer.dispatch_pixels(pixels, max_batch))

    def fetch_results(self, handle: LaneHandle) -> Dict[str, np.ndarray]:
        with self._turn():
            self._send(FETCH, handle.seq)
            finish = self._collective(lambda: self.analyzer._start_fetch(handle.pending))
        return self._collective(finish)  # the wait for the device, out of turn

    def classify_pixels(self, pixels: np.ndarray,
                        max_batch: Optional[int] = None) -> Dict[str, np.ndarray]:
        return self.fetch_results(self.dispatch_pixels(pixels, max_batch))

    def warmup(self, batch_sizes: Optional[Sequence[int]] = None) -> None:
        with self._turn():
            self._send(WARMUP, 0, sizes=batch_sizes)
            self._collective(lambda: self.analyzer.warmup(batch_sizes))

    def close(self) -> None:
        """Send the stop command, once (not on a broken lane); later calls
        raise ``LaneError``."""
        self._stop_beat.set()
        with self._turn(record=False):
            if self._closed:
                return
            self._closed = True
            if not self.broken.is_set():
                self._send(STOP, 0)

    # ------------------------------------------------------------------
    # The other ranks
    # ------------------------------------------------------------------

    def follow(self) -> int:
        """Make rank 0's calls, in its order, until it stops; returns 0. A
        call that fails here raises: the ranks would be out of step."""
        pending: Dict[int, List[tuple]] = {}
        waits: Deque[Callable[[], Any]] = collections.deque()
        self.log(f"rank {self.rank} of {self.world} follows rank 0's engine calls")
        while True:
            op, seq, max_batch, pixels, sizes = self._receive()
            if op == STOP:
                break
            if op == DISPATCH:
                pending[seq] = self.analyzer.dispatch_pixels(pixels, max_batch)
            elif op == FETCH:
                waits.append(self.analyzer._start_fetch(pending.pop(seq)))
            elif op == WARMUP:
                self.analyzer.warmup(sizes)
            while len(waits) > FOLLOWER_DEPTH:
                waits.popleft()()
        for wait in waits:
            wait()
        self.log(f"rank {self.rank} stops with rank 0")
        return 0

    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def _turn(self, record: bool = True):
        """This thread's turn on the lane, in the order of arrival; the
        wait is the ``lane_wait`` stage."""
        t0 = time.perf_counter()
        with self._cond:
            ticket = self._tickets
            self._tickets += 1
            while self._serving != ticket:
                self._cond.wait()
        try:
            if record:
                self.analyzer.metrics.stages.record("lane_wait", time.perf_counter() - t0)
                self._check()
            yield
        finally:
            with self._cond:
                self._serving += 1
                self._cond.notify_all()

    def _check(self) -> None:
        if self.broken.is_set():
            raise LaneError(f"the engine lane of {self.world} ranks broke: {self.error!r}")
        if self._closed:
            raise LaneError("the engine lane is closed")

    def _break(self, e: BaseException) -> None:
        if self.error is None:
            self.error = e
        self.broken.set()

    def _collective(self, fn: Callable[[], Any]) -> Any:
        """``fn()``, whose failure breaks the lane: the other ranks may wait
        in a collective that rank 0 left."""
        try:
            return fn()
        except Exception as e:
            self._break(e)
            raise

    def _send(self, op: int, seq: int, max_batch: Optional[int] = None,
              pixels: Optional[np.ndarray] = None,
              sizes: Optional[Sequence[int]] = None) -> None:
        header = [0] * HEADER
        header[:5] = [op, seq, max_batch or 0, -1, 0]
        if pixels is not None:
            kinds = [np_t for np_t, _ in DTYPES]
            if pixels.dtype.type not in kinds or pixels.ndim > MAX_RANK:
                raise ValueError(f"the lane sends pixels of {[k.__name__ for k in kinds]} up to "
                                 f"rank {MAX_RANK}, not {pixels.dtype} of shape {pixels.shape}")
            header[3:5] = [kinds.index(pixels.dtype.type), pixels.ndim]
            header[SHAPE_AT:SHAPE_AT + pixels.ndim] = pixels.shape
        if sizes is None:
            header[SIZES_AT] = -1
        else:
            sizes = [int(b) for b in sizes]
            if len(sizes) > MAX_SIZES:
                raise ValueError(f"the lane sends at most {MAX_SIZES} warmup buckets")
            header[SIZES_AT:SIZES_AT + 1 + len(sizes)] = [len(sizes), *sizes]
        t0 = time.perf_counter()
        try:
            dist.broadcast(torch.tensor(header, dtype=torch.int64), src=0, group=self.group)
            if pixels is not None:
                dist.broadcast(torch.from_numpy(pixels), src=0, group=self.group)
        except Exception as e:
            self._break(e)
            raise
        self._last_send = time.monotonic()
        if op != HEARTBEAT:
            self.analyzer.metrics.stages.record("lane_send", time.perf_counter() - t0)

    def _receive(self) -> tuple:
        """The next command: (op, seq, max_batch, pixels, warmup buckets)."""
        header = torch.zeros(HEADER, dtype=torch.int64)
        dist.broadcast(header, src=0, group=self.group)
        h = header.tolist()
        op, seq, max_batch, kind, ndim = h[:5]
        pixels = None
        if kind >= 0:
            t = torch.empty(h[SHAPE_AT:SHAPE_AT + ndim], dtype=DTYPES[kind][1])
            dist.broadcast(t, src=0, group=self.group)
            pixels = t.numpy()
        n = h[SIZES_AT]
        sizes = None if n < 0 else h[SIZES_AT + 1:SIZES_AT + 1 + n]
        return op, seq, max_batch or None, pixels, sizes

    def _beat(self) -> None:
        """Rank 0's heartbeat: a command whenever the lane has sent none for
        HEARTBEAT_S; ends when the lane closes or breaks."""
        while not self._stop_beat.wait(HEARTBEAT_S / 4):
            if time.monotonic() - self._last_send < HEARTBEAT_S:
                continue
            with self._turn(record=False):
                if self._closed or self.broken.is_set():
                    return
                if time.monotonic() - self._last_send >= HEARTBEAT_S:
                    try:
                        self._send(HEARTBEAT, 0)
                    except Exception as e:  # noqa: BLE001 - the lane is broken; the server stops
                        self.log(f"engine lane heartbeat failed: {e!r}")
                        return
