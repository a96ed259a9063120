"""Serving application assembly — the port of ``aiic_tpu.serve.app``.

Wires the engine into the REST path:

    POST /analyze bytes -> decode (native pool) -> DynamicBatcher
      -> [dispatch bucket -> device program] ─┐ pipelined (depth 2)
      -> [fetch results  -> per-request dict] ┘
      -> JSON response

The batcher runs pipelined: the collector thread dispatches bucket i+1
while the completer thread waits on bucket i's results.
``pipeline_depth=0`` gives synchronous dispatch+fetch per bucket. The
worker CLI, benches and tests drive this one assembly.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple


def make_run_batch(analyzer, confidence: float, max_batch: int,
                   pipeline_depth: int) -> Tuple[Callable, Optional[Callable]]:
    """(run_batch, fetch_batch) for DynamicBatcher over the analyzer.
    fetch_batch is None when pipeline_depth == 0 (synchronous mode)."""

    def assemble(res, n: int):
        # the full reference result contract (main.py:383-391, 461-467): all
        # five keys on every REST result, the batch CLI's strings
        return [analyzer._result(res, i, True, confidence) for i in range(n)]

    if pipeline_depth <= 0:
        def run_batch_sync(pixels):
            res = analyzer.classify_pixels(pixels, max_batch=max_batch)
            return assemble(res, pixels.shape[0])

        return run_batch_sync, None

    def run_batch(pixels):
        # dispatch-only: returns a pending handle plus the row count
        return analyzer.dispatch_pixels(pixels, max_batch=max_batch), pixels.shape[0]

    def fetch_batch(handle):
        pending, n = handle
        return assemble(analyzer.fetch_results(pending), n)

    return run_batch, fetch_batch


def make_analyze_bytes(
    analyzer,
    batcher,
    *,
    request_timeout: float = 30.0,
    fast_decode: bool = False,
    wire_format: str = "hwc",
    on_dead_letter: Optional[Callable[[int], None]] = None,
) -> Callable[[bytes], Dict[str, Any]]:
    """bytes -> result dict: decode on the handler thread (native pool for
    JPEG, per-blob Python fallback for PNG/WebP/...), submit the uint8 crop
    to the batcher, wait bounded by ``request_timeout``."""
    from aiic_tpu_torch.data.native_loader import preprocess_any_batch
    from aiic_tpu_torch.serve.metrics import GLOBAL_METRICS

    size = analyzer.config.image_size
    # patch wire: the native decode emits patch-major directly; the
    # non-JPEG fallback crop gets the Python repack
    wire_patch = analyzer.config.patch_size if wire_format == "patch" else 0

    def dead_letter(n):
        if on_dead_letter is not None:
            on_dead_letter(n)

    def _submit(item):
        import concurrent.futures

        fut = batcher.submit(item)
        try:
            return fut.result(timeout=request_timeout)
        except (TimeoutError, concurrent.futures.TimeoutError) as e:
            # Only the CLIENT-side wait expiring is counted here; a
            # batch-level timeout already dead-lettered every member via
            # the batcher's on_timeout (counting both doubled the metric).
            if not fut.done():
                fut.cancel()  # still queued -> don't compute a result
                dead_letter(1)
            raise TimeoutError(
                f"request exceeded {request_timeout}s"
            ) from e

    def analyze_bytes(data: bytes):
        # All batcher items are uint8 (normalize fused on device); a mixed
        # uint8/float batch would silently corrupt under np.stack.
        with GLOBAL_METRICS.stages.stage("serve_decode"):
            pixels, ok = preprocess_any_batch(
                [data], size, fast=fast_decode, patch=wire_patch)
            if not ok[0]:
                return {"error": "could not decode image"}
        return _submit(pixels[0])

    return analyze_bytes


def make_analyze_batch(
    analyzer,
    batcher,
    *,
    request_timeout: float = 30.0,
    fast_decode: bool = False,
    wire_format: str = "hwc",
    max_items: int = 1024,
    fetch_workers: int = 8,
    on_dead_letter: Optional[Callable[[int], None]] = None,
) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    """Multi-image ingestion: one POST carries a whole image list, so the
    per-request HTTP and JSON overhead amortizes over the batch: the
    reference's production shape, a CSV of offer URLs (main.py:516-524) and
    per-apartment image lists (main_API.py:164-213).

    Payload: ``{"urls": [...]}`` and/or ``{"images_b64": [...]}`` (raw
    image bytes, base64). Returns ``{"results": [...]}`` in request order
    (urls first), each entry the full five-key reference result dict;
    fetch/decode failures get the reference's load-error record
    (main.py:420-426) instead of failing the whole request.

    The request STREAMS through ByteStreamLoader (the CSV-CLI's three-stage
    pipeline): URL fetch of chunk i+1 overlaps the native JPEG/PNG/WebP
    decode of chunk i and the batcher submission of chunk i-1, and memory
    holds at most two chunks of raw blobs — a 1024-URL request neither
    serializes fetch-all -> decode-all -> submit-all nor buffers every
    blob."""
    import base64
    import concurrent.futures
    import time

    from aiic_tpu_torch.data.pipeline import ByteStreamLoader
    from aiic_tpu_torch.serve.metrics import GLOBAL_METRICS

    size = analyzer.config.image_size
    wire_patch = analyzer.config.patch_size if wire_format == "patch" else 0

    LOAD_ERROR = {
        "is_interior": False,
        "interior_confidence": 0.0,
        "detected_category": "load error",
        "analysis": {},
        "reason": "Błąd ładowania: could not load image",
    }

    def dead_letter(n):
        if on_dead_letter is not None:
            on_dead_letter(n)

    def analyze_batch(payload: Dict[str, Any]) -> Dict[str, Any]:
        urls = payload.get("urls") or []
        b64 = payload.get("images_b64") or []
        if not isinstance(urls, list) or not isinstance(b64, list):
            raise ValueError("'urls' and 'images_b64' must be JSON arrays")
        n = len(urls) + len(b64)
        if n == 0:
            return {"results": []}
        if n > max_items:
            raise ValueError(
                f"batch of {n} exceeds max_items={max_items}; split the request"
            )

        sources: list = list(urls)
        for s in b64:
            try:
                sources.append(base64.b64decode(s))
            except Exception:
                sources.append(b"")  # ok-mask records the load error

        # The deadline covers the WHOLE request — fetch/decode included. A
        # 1024-slow-URL request must 504 at request_timeout, not stream
        # sources for minutes before the result wait even starts.
        deadline = time.monotonic() + request_timeout
        futs: list = [None] * n

        def request_timed_out():
            n_cancelled = sum(
                1 for f in futs if f is not None and f.cancel())
            dead_letter(n_cancelled)
            raise TimeoutError(f"batch request exceeded {request_timeout}s")

        try:
            if urls:
                # network fetch to overlap: three-stage stream (fetch chunk
                # i+1 || decode chunk i || submit chunk i-1, blobs bounded
                # at two chunks)
                loader = ByteStreamLoader(
                    sources, batch_size=min(64, n), size=size,
                    fetch_workers=min(fetch_workers, max(1, len(urls))),
                    fast=fast_decode, patch=wire_patch)
                it = iter(loader)
                try:
                    while True:
                        # fetch+decode wait for the NEXT chunk (0 when the
                        # pipeline keeps ahead of batcher submission)
                        with GLOBAL_METRICS.stages.stage("serve_decode"):
                            item = next(it, None)
                        if item is None:
                            break
                        pixels, ok, (start, end) = item
                        if time.monotonic() >= deadline:
                            request_timed_out()
                        for j in range(start, end):
                            if ok[j - start]:
                                futs[j] = batcher.submit(pixels[j - start])
                except Exception:
                    # release the stream's producer thread + fetch pool (an
                    # abandoned iterator would otherwise block on its queue)
                    if hasattr(it, "close"):
                        it.close()
                    raise
            else:
                # pure-bytes request: nothing to overlap with — decode in
                # chunks on the handler thread (no per-request stream thread
                # and fetch pool)
                from aiic_tpu_torch.data.native_loader import preprocess_any_batch

                for start in range(0, n, 64):
                    chunk = sources[start:start + 64]
                    with GLOBAL_METRICS.stages.stage("serve_decode"):
                        pixels, ok = preprocess_any_batch(
                            chunk, size, fast=fast_decode, patch=wire_patch)
                    if time.monotonic() >= deadline:
                        request_timed_out()
                    for j, good in enumerate(ok):
                        if good:
                            futs[start + j] = batcher.submit(pixels[j])
        except Exception:
            for f in futs:
                if f is not None:
                    f.cancel()
            raise

        results = []
        try:
            for f in futs:
                if f is None:
                    results.append(dict(LOAD_ERROR))
                    continue
                remaining = deadline - time.monotonic()
                results.append(f.result(timeout=max(remaining, 0.0)))
        except (TimeoutError, concurrent.futures.TimeoutError) as e:
            n_cancelled = 0
            for f in futs:
                if f is not None and not f.done():
                    f.cancel()
                    n_cancelled += 1
            dead_letter(n_cancelled)
            raise TimeoutError(
                f"batch request exceeded {request_timeout}s"
            ) from e
        return {"results": results}

    return analyze_batch


def build_serving_app(
    analyzer,
    db=None,
    *,
    confidence: float = 0.3,
    port: int = 3000,
    host: str = "127.0.0.1",
    max_batch: int = 64,
    max_wait_ms: float = 10.0,
    request_timeout: float = 30.0,
    max_queue: Optional[int] = 256,
    fast_decode: bool = False,
    wire_format: str = "hwc",
    pipeline_depth: int = 2,
    warm_buckets: Optional[Sequence[int]] = None,
    warm_async: bool = True,
    max_batch_items: int = 1024,
    log: Callable[[str], None] = print,
):
    """Assemble the full serving stack. Returns (server, batcher, warmed):
    the caller owns server.serve_forever() / server.shutdown() and
    batcher.close(). ``warmed`` is the Event backing GET /ready."""
    from aiic_tpu_torch.serve.batcher import DynamicBatcher
    from aiic_tpu_torch.serve.metrics import GLOBAL_METRICS
    from aiic_tpu_torch.serve.rest import make_server

    def dead_letter(n):
        GLOBAL_METRICS.inc("analyze_dead_letters_total", n)
        # persist a queryable record too (GET /dead-letters), not only the
        # counter; REST requests have no DB image id, so the record carries
        # the count and source
        if db is not None and hasattr(db, "record_dead_letter"):
            try:
                db.record_dead_letter(
                    None, f"analyze request timed out ({n} image(s))",
                    source="rest", count=n)
            except Exception:  # noqa: BLE001 - observability must not 500
                pass

    run_batch, fetch_batch = make_run_batch(
        analyzer, confidence, max_batch, pipeline_depth)
    batcher = DynamicBatcher(
        run_batch, max_batch=max_batch, max_wait_ms=max_wait_ms,
        batch_timeout_s=max(request_timeout, 1.0), on_timeout=dead_letter,
        max_queue=max_queue or None,
        fetch_batch=fetch_batch, pipeline_depth=pipeline_depth,
    )
    analyze_bytes = make_analyze_bytes(
        analyzer, batcher, request_timeout=request_timeout,
        fast_decode=fast_decode, wire_format=wire_format,
        on_dead_letter=dead_letter,
    )
    analyze_batch = make_analyze_batch(
        analyzer, batcher, request_timeout=request_timeout,
        fast_decode=fast_decode, wire_format=wire_format,
        max_items=max_batch_items, on_dead_letter=dead_letter,
    )

    # Serve immediately; warm the buckets in the background and flip /ready
    # when done — load balancers gate on /ready, /health stays
    # liveness-only.
    warmed = threading.Event()

    def _warm():
        if warm_buckets is None:
            # every bucket up to max_batch, the full one included
            buckets, b = [], 1
            while b < max_batch:
                buckets.append(b)
                b <<= 1
            buckets.append(max_batch)
        else:
            buckets = [b for b in warm_buckets if b <= max_batch]
        log(f"warming classify buckets {buckets}...")
        for attempt in (1, 2):
            try:
                analyzer.warmup(buckets)
                warmed.set()
                log("warmup complete — /ready now true")
                return
            except Exception as e:  # noqa: BLE001 - must not die silently
                log(f"WARMUP FAILED (attempt {attempt}/2): "
                    f"{type(e).__name__}: {e}")
        log("WARMUP permanently failed — /ready will stay 503; "
            "fix the cause and restart")

    if warm_async:
        threading.Thread(target=_warm, daemon=True).start()
    else:
        _warm()
    server = make_server(db=db, analyze_fn=analyze_bytes,
                         analyze_batch_fn=analyze_batch, port=port, host=host,
                         ready_fn=warmed.is_set)
    return server, batcher, warmed
