#!/usr/bin/env python3
"""Serving load test of the PyTorch port: concurrent clients against the
dynamic batcher — the twin of ``tools/serve_bench.py``.

    python3 tools/torch_serve_bench.py [--clients 16,64] [--per-client 8]
        [--depths 2,0] [--open-rates 100,200,400] [--open-seconds 6]
        [--max-batch 64] [--max-wait-ms 10] [--model vit_b_16|tiny]
        [--device cuda|cpu]

The same run_batch path the REST server uses (``serve.app.make_run_batch``
into ``serve.batcher.DynamicBatcher``) on the worker's default engine
(``InteriorAnalyzer(training_data=[], dtype=torch.bfloat16)``: bf16, the HWC
wire, row 5 on the card), without HTTP or JPEG decode. Closed-loop mode
(``--clients``): N synchronous clients each send requests back to back.
Open-loop mode (``--open-rates``): a pacer submits at a fixed offered rate
whatever the completions; completion latencies come from the futures. The
pacer is the JAX tool's (``time.sleep`` to each target time), so the rate
it achieved goes to stderr: a rate the host could not offer is not the
batcher's limit. Every (load point, depth) pair runs in this process.

One JSON line per load point with the JAX tool's keys; the card's name and
power limit and the achieved offered rate go to stderr. ``--model tiny``
(TINY_TEST) is for the tests; ``--device`` (default ``$AIIC_PLATFORM``, else
``cuda``) exits without a card unless it is ``cpu``. ``main(argv)`` returns
the printed records.
"""

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def closed_loop(batcher, img, clients, per_client):
    lats = []

    def client(_):
        out = []
        for _ in range(per_client):
            t0 = time.perf_counter()
            batcher(img)
            out.append(time.perf_counter() - t0)
        return out

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=clients) as pool:
        for res in pool.map(client, range(clients)):
            lats.extend(res)
    wall = time.perf_counter() - t0
    return lats, wall, 0


def open_loop(batcher, img, rate, seconds):
    """Submit at a fixed offered rate; measure completion latency per
    request. Rejections (admission control) and errors count separately.
    The rate the pacer achieved goes to stderr.

    A request's latency ends when its future completes (a done callback
    stamps it). The JAX tool reads each future only after the pacer has
    submitted the last request, so its latency includes the rest of the
    submission window: about half of ``--open-seconds`` at the median."""
    period = 1.0 / rate
    n = int(rate * seconds)
    entries = []
    errors = 0
    t_start = time.perf_counter()
    for i in range(n):
        target = t_start + i * period
        now = time.perf_counter()
        if target > now:
            time.sleep(target - now)
        try:
            t0 = time.perf_counter()
            fut = batcher.submit(img)
            done = []
            fut.add_done_callback(lambda _f, done=done: done.append(time.perf_counter()))
            entries.append((t0, fut, done))
        except Exception:
            errors += 1
    offered_s = time.perf_counter() - t_start
    log(f"open loop at {rate:g} QPS: {n} submitted in {offered_s:.3f} s, an achieved offered "
        f"rate of {n / offered_s:.1f} QPS" if offered_s > 0 else f"open loop: {n} submitted")
    lats = []
    for t0, fut, done in entries:
        try:
            fut.result(timeout=120)
            # the callback runs just after result() is released
            lats.append((done[0] if done else time.perf_counter()) - t0)
        except Exception:
            errors += 1
    wall = time.perf_counter() - t_start
    return lats, wall, errors


def main(argv=None) -> list:
    from aiic_tpu_torch.utils.platform import apply_platform_env, device_line, require_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clients", default="16")
    ap.add_argument("--per-client", type=int, default=8)
    ap.add_argument("--depths", default="2")
    ap.add_argument("--open-rates", default="",
                    help="offered QPS list: switches to open-loop arrivals")
    ap.add_argument("--open-seconds", type=float, default=6.0)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=10.0)
    ap.add_argument("--model", default="vit_b_16", choices=["vit_b_16", "tiny"],
                    help="tiny (TINY_TEST) is for the tests")
    ap.add_argument("--device", default=apply_platform_env(),
                    help="torch device (default $AIIC_PLATFORM, else cuda; cpu runs the plain "
                         "versions)")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    import torch

    from aiic_tpu_torch.engine import InteriorAnalyzer
    from aiic_tpu_torch.models.config import TINY_TEST, VIT_B_16
    from aiic_tpu_torch.serve.app import make_run_batch
    from aiic_tpu_torch.serve.batcher import DynamicBatcher

    config = {"vit_b_16": VIT_B_16, "tiny": TINY_TEST}[args.model]
    log(f"device={device} ({device_line(device)}) model={config.name}")
    analyzer = InteriorAnalyzer(config=config, training_data=[], dtype=torch.bfloat16,
                                max_batch=args.max_batch, device=device)

    rng = np.random.default_rng(0)
    # uint8 items: the wire format the REST path uses (normalize on device)
    img = rng.integers(0, 256, (config.image_size, config.image_size, 3), dtype=np.uint8)
    log("warming buckets...")
    analyzer.warmup()

    records = []
    for depth in [int(d) for d in args.depths.split(",")]:
        run_batch, fetch_batch = make_run_batch(
            analyzer, confidence=0.3, max_batch=args.max_batch, pipeline_depth=depth)
        batcher = DynamicBatcher(
            run_batch, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            fetch_batch=fetch_batch, pipeline_depth=depth)
        try:
            batcher(img)  # warm this batcher's path
            if args.open_rates:
                points = [("open", float(r)) for r in args.open_rates.split(",")]
            else:
                points = [("closed", int(c)) for c in args.clients.split(",")]
            for kind, load in points:
                snap0 = batcher.metrics.snapshot()
                if kind == "open":
                    lats, wall, errors = open_loop(batcher, img, load, args.open_seconds)
                else:
                    lats, wall, errors = closed_loop(batcher, img, load, args.per_client)
                snap1 = batcher.metrics.snapshot()
                lats.sort()
                n = len(lats)
                if n == 0:
                    rec = {"kind": kind, "load": load, "errors": errors,
                           "error": "no completions"}
                else:
                    batches = snap1.get("batches_total", 0) - snap0.get("batches_total", 0)
                    images = snap1.get("images_total", 0) - snap0.get("images_total", 0)
                    rec = {
                        "metric": "serve_p50_latency_ms",
                        "value": round(lats[n // 2] * 1e3, 1),
                        "p90_ms": round(lats[int(n * 0.9)] * 1e3, 1),
                        "p99_ms": round(lats[int(n * 0.99)] * 1e3, 1),
                        "qps": round(n / wall, 1),
                        "kind": kind,
                        "load": load,
                        "requests": n,
                        "errors": errors,
                        "pipeline_depth": depth,
                        "avg_batch": round(images / batches, 1) if batches else 0,
                    }
                print(json.dumps(rec), flush=True)
                records.append(rec)
        finally:
            batcher.close()
    return records


if __name__ == "__main__":
    main()
