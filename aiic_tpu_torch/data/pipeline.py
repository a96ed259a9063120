"""Double-buffered host input pipelines — the port of ``aiic_tpu.data.pipeline``.

Streams image sources through: (fetch ->) native decode+resize pool -> uint8
batches -> (caller) device transfer and the classify program. A background
producer thread keeps ``depth`` prepared batches ahead of the consumer, so
host fetch and decode overlap device compute.

Two loaders share the scaffolding:
- ``PrefetchingLoader``  — local image paths straight into the decode pool;
- ``ByteStreamLoader``   — arbitrary byte sources (URLs, paths, raw blobs):
  a sliding-window fetch pool downloads ahead of the decode stage, which in
  turn runs ahead of device dispatch (three-stage pipeline).

Unlike the JAX package's copy, the producer ends the stream with a blocking
put of its end marker that gives way only to ``close()``: a consumer slower
than the producer still sees the end (the JAX copy drops the marker when
the queue is full, and such a consumer then waits forever).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray, Tuple[int, int]]


class _StreamClosed(Exception):
    """Raised inside the producer when the consumer closed the stream."""


class _StreamQueue(queue.Queue):
    """Bounded queue whose blocking put() aborts once the consumer has
    closed the stream: an abandoned iterator (consumer raised mid-stream,
    e.g. the serving batch endpoint hitting admission control) must not
    leave the producer thread and its fetch pool blocked on a full queue."""

    def __init__(self, maxsize: int, stop: threading.Event):
        super().__init__(maxsize)
        self._stop = stop

    def put(self, item, block=True, timeout=None):  # noqa: D102
        if not block or timeout is not None:
            return super().put(item, block, timeout)
        while True:
            if self._stop.is_set():
                raise _StreamClosed()
            try:
                return super().put(item, True, 0.1)
            except queue.Full:
                continue


class _Stream:
    """Iterator over ``produce``'s queue items with producer-exception
    propagation and explicit ``close()``. A swallowed producer exception
    would make analyze_images_batch return PARTIAL results with rc=0
    (every path after the failure point simply missing), so failures
    re-raise in the consumer."""

    _SENTINEL = object()

    def __init__(self, produce: Callable[["queue.Queue"], None], depth: int):
        self._stop = threading.Event()
        self._q = _StreamQueue(depth, self._stop)
        self._error: List[BaseException] = []

        def run():
            try:
                produce(self._q)
            except _StreamClosed:
                return  # consumer is gone; nothing to report
            except BaseException as e:  # noqa: BLE001 - re-raised in consumer
                self._error.append(e)
            finally:
                try:
                    self._q.put(self._SENTINEL)  # waits for room; close() ends the wait
                except _StreamClosed:
                    pass

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is self._SENTINEL:
            if self._error:
                raise self._error[0]
            raise StopIteration
        return item

    def close(self) -> None:
        """Release the producer: unblocks any pending put and drains the
        queue so its thread (and fetch pool) can exit."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def _stream(produce: Callable[["queue.Queue"], None], depth: int) -> "_Stream":
    return _Stream(produce, depth)


class PrefetchingLoader:
    """Local JPEG files -> (uint8 pixel batch, ok mask, index range)."""

    def __init__(
        self,
        paths: Sequence[str],
        batch_size: int = 256,
        size: int = 224,
        depth: int = 2,
        num_threads: int = 0,
        fast: bool = False,
        patch: int = 0,
    ):
        self.paths = list(paths)
        self.batch_size = batch_size
        self.size = size
        self.depth = depth
        self.num_threads = num_threads
        # DCT-scaled decode (native_loader.preprocess_jpeg_batch fast=True):
        # quality-approximate, for decode-bound deployments
        self.fast = fast
        # patch > 0: batches come out patch-major (n, (size/p)^2, 3*p*p) —
        # the wire format whose normalization folds into the embed matmul;
        # the C++ pool emits it directly (native_loader patch=)
        self.patch = patch

    def __len__(self):
        return (len(self.paths) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Batch]:
        from aiic_tpu_torch.data.native_loader import preprocess_jpeg_files

        def produce(q):
            for start in range(0, len(self.paths), self.batch_size):
                chunk = self.paths[start : start + self.batch_size]
                pixels, ok = preprocess_jpeg_files(
                    chunk, self.size, num_threads=self.num_threads,
                    fast=self.fast, patch=self.patch,
                )
                q.put((pixels, ok, (start, start + len(chunk))))

        return _stream(produce, self.depth)


_fetch_tls = threading.local()


def fetch_source(source: Union[str, bytes]) -> bytes:
    """One byte source -> raw bytes (b"" on failure — the decode stage's ok
    mask then records a load error for that index). Sources: http(s) URLs
    (the reference's production shape, main.py:121-128 — same 30 s timeout),
    local paths, or pass-through raw bytes. HTTP fetches reuse a
    thread-local keep-alive session, so each fetch-pool worker holds one
    connection per host instead of paying TCP (+TLS) setup per image."""
    if isinstance(source, (bytes, bytearray)):
        return bytes(source)
    try:
        if source.startswith("http"):
            import requests

            session = getattr(_fetch_tls, "session", None)
            if session is None:
                session = _fetch_tls.session = requests.Session()
            r = session.get(source, timeout=30.0)
            r.raise_for_status()
            return r.content
        with open(source, "rb") as f:
            return f.read()
    except Exception:
        return b""


class ByteStreamLoader:
    """Arbitrary byte sources -> (uint8 pixel batch, ok mask, index range),
    three-stage pipelined: a ``fetch_workers``-wide pool downloads batch i+1
    while the native pool decodes batch i and the consumer dispatches batch
    i-1 to the device.

    Decode numerics are identical to the eager byte path: JPEGs through the
    native PIL-exact decode+resize pool, anything else through the per-blob
    Python fallback (native_loader.preprocess_any_batch)."""

    def __init__(
        self,
        sources: Sequence[Union[str, bytes]],
        batch_size: int = 256,
        size: int = 224,
        depth: int = 2,
        fetch_workers: int = 8,
        num_threads: int = 0,
        fast: bool = False,
        patch: int = 0,
        fetch_fn: Optional[Callable[[Union[str, bytes]], bytes]] = None,
    ):
        self.sources = list(sources)
        self.batch_size = batch_size
        self.size = size
        self.depth = depth
        self.fetch_workers = fetch_workers
        self.num_threads = num_threads
        self.fast = fast
        self.patch = patch
        self.fetch_fn = fetch_fn or fetch_source

    def __len__(self):
        return (len(self.sources) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Batch]:
        from aiic_tpu_torch.data.native_loader import preprocess_any_batch

        def produce(q):
            from concurrent.futures import ThreadPoolExecutor

            n, bs = len(self.sources), self.batch_size
            with ThreadPoolExecutor(max_workers=self.fetch_workers) as pool:
                # one-batch fetch lookahead: bounded memory (at most 2 batches
                # of raw blobs in flight), full network/decode overlap
                futs_next = [pool.submit(self.fetch_fn, s) for s in self.sources[:bs]]
                for start in range(0, n, bs):
                    futs = futs_next
                    futs_next = [
                        pool.submit(self.fetch_fn, s)
                        for s in self.sources[start + bs : start + 2 * bs]
                    ]
                    blobs = [f.result() for f in futs]
                    pixels, ok = preprocess_any_batch(
                        blobs, self.size, num_threads=self.num_threads,
                        fast=self.fast, patch=self.patch,
                    )
                    q.put((pixels, ok, (start, start + len(blobs))))

        return _stream(produce, self.depth)
