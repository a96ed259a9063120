"""Worker / serving CLI — the port of ``aiic_tpu.cli.worker``.

    python -m aiic_tpu_torch.cli.worker --serve [--port 3000]   # REST, dynamic batching
    python -m aiic_tpu_torch.cli.worker --max-apartments 10     # drain the queue once

The JAX package's flags and defaults (the reference worker's ``--export-only
--use-lora --lora-weights --max-apartments --batch-size --confidence``, plus
``--serve``, ``--mongo-uri``, ``--seed-demo`` and the serving knobs); the
engine flags come from :class:`aiic_tpu_torch.cli.common.EngineArgs`, with
``--device`` (default ``$AIIC_PLATFORM``, else ``cuda``; ``cpu`` runs the
plain versions).

``--mesh-devices N`` serves or drains over an N-rank data-parallel mesh,
one process a device (``torchrun --nproc-per-node N -m
aiic_tpu_torch.cli.worker --mesh-devices N --serve``). Rank 0 leads: it
alone binds the port, reads and writes the DB, decodes, fetches URLs and
exports, and its engine calls go through one ordered lane
(``parallel.lane``) that every other rank follows until rank 0 stops.
SIGTERM to rank 0 (or to every rank, as torchrun forwards it) ends every
rank with exit code 0; a dead follower makes rank 0 exit 1.
``--export-only`` runs on rank 0 alone.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
from typing import Callable

from aiic_tpu_torch.cli.common import EngineArgs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Apartment-analysis worker / REST server "
                                            "(PyTorch port)")
    p.add_argument("--export-only", action="store_true")
    p.add_argument("--max-apartments", type=int)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--confidence", type=float, default=0.3)
    p.add_argument("--mongo-uri", type=str, help="defaults to $MONGO_URI; else in-memory DB")
    p.add_argument("--seed-demo", action="store_true")
    p.add_argument("--serve", action="store_true", help="start the REST API instead of one-shot drain")
    p.add_argument("--port", type=int, default=3000)
    p.add_argument("--request-timeout", type=float, default=30.0,
                   help="seconds before a POST /analyze request is failed "
                        "(504) and dead-lettered instead of blocking forever")
    p.add_argument("--max-queue", type=int, default=256,
                   help="admission-control bound on queued /analyze requests; "
                        "when full, new requests fast-fail with 503 + "
                        "Retry-After instead of queueing past their deadline "
                        "(0 = unbounded)")
    p.add_argument("--max-batch", type=int, default=64,
                   help="dynamic-batcher bucket ceiling for /analyze")
    p.add_argument("--max-wait-ms", type=float, default=10.0,
                   help="max time the oldest queued request waits before its "
                        "batch closes (the occupancy/latency knob)")
    p.add_argument("--max-batch-items", type=int, default=1024,
                   help="max images one POST /analyze-batch request may "
                        "carry (urls + images_b64)")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="dispatched-but-unfetched batches kept in flight "
                        "(overlaps device compute/result fetch with the next "
                        "batch's dispatch; 0 = synchronous per-batch serving)")
    # serving defaults to the bf16 fast path; the batch CLI keeps fp32 parity
    EngineArgs.add_args(p, dtype_default="bfloat16")
    return p


def on_sigterm(lead: bool) -> threading.Event:
    """SIGTERM's handling on this rank. Rank 0 raises ``SystemExit(0)`` as
    the JAX worker does (it unwinds cleanly from any phase, the server's
    and the engine build's included; above one rank it closes the lane,
    which stops the others). Another rank only records it in the returned
    event: it may be blocked in a collective, and it stops when rank 0's
    stop command comes (or, once SIGTERM came, with exit code 0 when rank 0
    is gone)."""
    import signal

    terminated = threading.Event()

    def _graceful(_sig, _frm):
        terminated.set()
        if lead:
            raise SystemExit(0)

    signal.signal(signal.SIGTERM, _graceful)
    return terminated


def main(argv=None):
    args = build_parser().parse_args(argv)
    lead = int(os.environ.get("RANK", "0")) == 0
    if args.export_only and not lead:
        return 0  # rank 0 exports alone
    db = None
    if lead:
        from aiic_tpu_torch.serve.db import connect_db, seed_demo_data

        db = connect_db(args.mongo_uri)
        if args.seed_demo and hasattr(db, "insert_apartment"):
            seed_demo_data(db)
        if args.export_only:
            path = db.export_analysis_results()
            print(f"exported -> {path}")
            return 0

    # The graceful-termination handler goes in before the engine is built:
    # the build (weights, kernel library, text features) is the longest
    # startup phase.
    terminated = on_sigterm(lead)
    try:
        analyzer = EngineArgs.from_args(args).build_analyzer()
        return run_rank(args, analyzer, db)
    except Exception:
        if lead or not terminated.is_set():
            raise
        return 0  # SIGTERM came, and rank 0 went first


def run_rank(args, analyzer, db=None, log: Callable[[str], None] = print) -> int:
    """What a rank of the worker runs once its engine is built: ``--serve``
    or the one-shot drain. On a mesh above one rank, rank 0 leads through an
    :class:`~aiic_tpu_torch.parallel.lane.EngineLane` (it alone binds the
    port, reads and writes the DB, decodes, fetches and exports) and returns
    1 if the lane breaks; every other rank follows it until it stops, and
    returns 0."""
    lane = None
    if analyzer.mesh is not None and analyzer.mesh.size() > 1:
        from aiic_tpu_torch.parallel.lane import EngineLane

        lane = EngineLane(analyzer, log=log)
        if lane.rank != 0:
            return lane.follow()
    engine = analyzer if lane is None else lane
    try:
        if args.serve:
            return _serve(args, engine, db, lane, log)
        return _drain(args, engine, db, lane, log)
    finally:
        if lane is not None:
            lane.close()


def _serve(args, engine, db, lane, log) -> int:
    from aiic_tpu_torch.serve.app import build_serving_app

    server, batcher, _warmed = build_serving_app(
        engine, db=db,
        confidence=args.confidence,
        port=args.port,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        request_timeout=args.request_timeout,
        max_queue=args.max_queue or None,
        fast_decode=args.fast_decode,
        wire_format=args.wire_format,
        pipeline_depth=args.pipeline_depth,
        max_batch_items=args.max_batch_items,
        log=log,
    )
    log(f"serving on :{server.server_address[1]} (endpoints: /health /ready /apartments "
        f"/process-pending /process/:id /results /export /dead-letters "
        f"/metrics, POST /analyze, POST /analyze-batch)")
    if lane is None:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0
    try:
        return _led(lambda: server.serve_forever() or 0, lane, log)
    finally:
        server.shutdown()
        batcher.close()


def _drain(args, engine, db, lane, log) -> int:
    from aiic_tpu_torch.serve.worker import process_apartments_pipeline

    def drain() -> int:
        out = process_apartments_pipeline(
            max_apartments=args.max_apartments,
            batch_size=args.batch_size,
            confidence_threshold=args.confidence,
            db=db,
            analyzer=engine,
            log=log,
        )
        if out:
            log(f"exported -> {out}")
        return 0

    return drain() if lane is None else _led(drain, lane, log)


def _led(work: Callable[[], int], lane, log) -> int:
    """``work()`` on a thread of its own, the main thread waiting on it: a
    SIGTERM (``SystemExit``) lands here, never inside a lane call. Returns
    work's code, or 1 once the lane has broken."""
    done, box = threading.Event(), {}

    def run():
        try:
            box["rc"] = work()
        except BaseException as e:  # noqa: BLE001 - re-raised in the main thread
            box["error"] = e
        finally:
            done.set()

    threading.Thread(target=run, daemon=True, name="aiic-led").start()
    while not done.wait(0.5):
        if lane.broken.is_set():
            break
    if lane.broken.is_set():
        log(f"the engine lane broke ({lane.error!r}): rank 0 stops")
        return 1
    if "error" in box:
        raise box["error"]
    return box["rc"]


if __name__ == "__main__":
    sys.exit(main())
