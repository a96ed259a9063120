"""Worker / serving CLI — the port of ``aiic_tpu.cli.worker``.

    python -m aiic_tpu_torch.cli.worker --serve [--port 3000]   # REST, dynamic batching
    python -m aiic_tpu_torch.cli.worker --max-apartments 10     # drain the queue once

The JAX package's flags and defaults (the reference worker's ``--export-only
--use-lora --lora-weights --max-apartments --batch-size --confidence``, plus
``--serve``, ``--mongo-uri``, ``--seed-demo`` and the serving knobs); the
engine flags come from :class:`aiic_tpu_torch.cli.common.EngineArgs`, with
``--device`` (default ``cuda``; ``cpu`` runs the plain versions).
"""

from __future__ import annotations

import argparse
import sys

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


def main(argv=None):
    args = build_parser().parse_args(argv)


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
    # startup phase, and SIGTERM as SystemExit unwinds cleanly from any
    # phase, the server's included.
    import signal

    def _graceful(_sig, _frm):
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _graceful)

    analyzer = EngineArgs.from_args(args).build_analyzer()

    if args.serve:
        from aiic_tpu_torch.serve.app import build_serving_app

        # SIGTERM handler was installed before engine construction (above).
        server, _batcher, _warmed = build_serving_app(
            analyzer, db=db,
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
        )
        print(f"serving on :{args.port} (endpoints: /health /ready /apartments "
              f"/process-pending /process/:id /results /export /dead-letters "
              f"/metrics, POST /analyze, POST /analyze-batch)")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0

    from aiic_tpu_torch.serve.worker import process_apartments_pipeline

    out = process_apartments_pipeline(
        max_apartments=args.max_apartments,
        batch_size=args.batch_size,
        confidence_threshold=args.confidence,
        db=db,
        analyzer=analyzer,
    )
    if out:
        print(f"exported -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
