#!/usr/bin/env python3
"""End-to-end REST serving benchmark of the PyTorch port — the twin of
``tools/rest_bench.py``.

    python3 tools/torch_rest_bench.py [--clients 1,8,32,64] [--per-client 20]
        [--max-batch 64] [--max-wait-ms 10] [--pipeline-depth 2]
        [--model vit_b_16|vit_b_32|vit_l_14|tiny] [--no-quantize]
        [--wire patch|hwc] [--fast-decode] [--sweep-wait 2,5,10,25,50]
        [--batch-images N,...] [--batch-urls N,...] [--png-clients N]
        [--limit-images 64] [--weights PATH] [--reference DIR]
        [--device cuda|cpu]

Drives the port's serving assembly (``serve.app.build_serving_app``, the
stack ``python -m aiic_tpu_torch.cli.worker --serve`` ships) with
concurrent HTTP clients POSTing JPEG bytes to /analyze, decode included:
sustained QPS, latency percentiles, batch occupancy. The engine is the
int8 serving configuration unless ``--no-quantize`` (bf16, ``--wire``).

``--reference`` (default ``$AIIC_REF``, else ``.``) takes the place of the
JAX tool's fixed reference path: its ``dataset_images/`` are the payloads
(8 synthetic 640x480 JPEGs where it is missing) and its
``interior_dataset.json`` the vocabulary. No text-feature cache is kept:
the JAX tool's cache holds features of the JAX package's random init, and
on the card the text tower takes less than the cache would save.
``--model tiny`` (TINY_TEST) is for the tests; ``--device`` (default
``$AIIC_PLATFORM``, else ``cuda``) exits without a card unless it is
``cpu``.

One JSON line per load point and a final summary line, with the JAX tool's
keys; the card's name and power limit and the decoder that ran (native or
the Python fallback) go to stderr. ``main(argv)`` returns the printed
records.
"""

import argparse
import http.client
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_load_point(port, payloads, clients, per_client, timeout=120.0):
    """clients threads x per_client sequential requests over keep-alive
    connections. Returns (latencies sorted, wall seconds, errors)."""
    lats = []
    error_kinds: dict = {}
    lock = threading.Lock()
    start_gate = threading.Barrier(clients + 1)

    def client(ci):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        mine = []
        my_err: dict = {}
        start_gate.wait()
        for i in range(per_client):
            body = payloads[(ci * per_client + i) % len(payloads)]
            t0 = time.perf_counter()
            try:
                conn.request("POST", "/analyze", body=body)
                resp = conn.getresponse()
                data = resp.read()
                if resp.status != 200 or b"error" in data[:60]:
                    kind = f"http_{resp.status}"
                    my_err[kind] = my_err.get(kind, 0) + 1
                else:
                    mine.append(time.perf_counter() - t0)
            except Exception as e:
                kind = type(e).__name__
                my_err[kind] = my_err.get(kind, 0) + 1
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        conn.close()
        with lock:
            lats.extend(mine)
            for k, v in my_err.items():
                error_kinds[k] = error_kinds.get(k, 0) + v

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    start_gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    lats.sort()
    return lats, wall, error_kinds


def run_batch_load_point(port, bodies, clients, per_client, timeout=300.0):
    """Like run_load_point but POSTs prebuilt JSON bodies to /analyze-batch
    (the multi-image protocol). Returns (latencies, wall, errors, images_ok)
    where images_ok counts result entries actually returned."""
    lats = []
    error_kinds: dict = {}
    images_ok = [0]
    lock = threading.Lock()
    start_gate = threading.Barrier(clients + 1)

    def client(ci):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        mine = []
        my_images = 0
        my_err: dict = {}
        start_gate.wait()
        for i in range(per_client):
            body = bodies[(ci * per_client + i) % len(bodies)]
            t0 = time.perf_counter()
            try:
                conn.request("POST", "/analyze-batch", body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                if resp.status != 200:
                    kind = f"http_{resp.status}"
                    my_err[kind] = my_err.get(kind, 0) + 1
                else:
                    mine.append(time.perf_counter() - t0)
                    my_images += len(json.loads(data)["results"])
            except Exception as e:
                kind = type(e).__name__
                my_err[kind] = my_err.get(kind, 0) + 1
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=timeout)
        conn.close()
        with lock:
            lats.extend(mine)
            images_ok[0] += my_images
            for k, v in my_err.items():
                error_kinds[k] = error_kinds.get(k, 0) + v

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    start_gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    lats.sort()
    return lats, wall, error_kinds, images_ok[0]


def summarize(tag, lats, wall, errs, clients, snap0, snap1, extra=None):
    n = len(lats)
    n_err = sum(errs.values()) if isinstance(errs, dict) else errs
    if n == 0:
        out = {"tag": tag, "clients": clients, "error": "all requests failed",
               "errors": n_err, "error_kinds": errs}
        print(json.dumps(out), flush=True)
        return out
    batches = snap1.get("batches_total", 0) - snap0.get("batches_total", 0)
    images = snap1.get("images_total", 0) - snap0.get("images_total", 0)
    out = {
        "tag": tag,
        "clients": clients,
        "requests": n,
        "errors": n_err,
        "qps": round(n / wall, 1),
        "p50_ms": round(lats[n // 2] * 1e3, 1),
        "p95_ms": round(lats[int(n * 0.95)] * 1e3, 1),
        "p99_ms": round(lats[min(n - 1, int(n * 0.99))] * 1e3, 1),
        "avg_batch": round(images / batches, 1) if batches else 0,
    }
    if isinstance(errs, dict) and errs:
        out["error_kinds"] = errs
    if extra:
        out.update(extra)
    print(json.dumps(out), flush=True)
    return out


def _payloads(img_dir: str, limit: int) -> list:
    payloads = []
    if os.path.isdir(img_dir):
        for name in sorted(os.listdir(img_dir))[:limit]:
            with open(os.path.join(img_dir, name), "rb") as f:
                payloads.append(f.read())
    if not payloads:  # synthetic fallback
        import io

        from PIL import Image

        rng = np.random.default_rng(0)
        for _ in range(8):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
                            ).save(buf, "JPEG", quality=90)
            payloads.append(buf.getvalue())
    return payloads


def main(argv=None) -> list:
    from aiic_tpu_torch.utils.platform import apply_platform_env, device_line, require_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clients", default="1,8,32,64")
    ap.add_argument("--per-client", type=int, default=20)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=10.0)
    ap.add_argument("--pipeline-depth", type=int, default=2)
    ap.add_argument("--model", default="vit_b_16",
                    choices=["vit_b_16", "vit_b_32", "vit_l_14", "tiny"])
    ap.add_argument("--no-quantize", action="store_true")
    ap.add_argument("--wire", default="patch", choices=["patch", "hwc"])
    ap.add_argument("--fast-decode", action="store_true")
    ap.add_argument("--sweep-wait", default="",
                    help="comma list of max_wait_ms values to sweep at the "
                         "largest client count (rebuilds the batcher only)")
    ap.add_argument("--batch-images", default="",
                    help="comma list of N values: also drive POST /analyze-batch with N "
                         "base64 images per request and report images/sec")
    ap.add_argument("--batch-urls", default="",
                    help="comma list of N values: drive POST /analyze-batch with N urls per "
                         "request served from a loopback HTTP server")
    ap.add_argument("--png-clients", type=int, default=0,
                    help="N > 0: also run one POST /analyze load point with the corpus "
                         "transcoded to PNG at N clients")
    ap.add_argument("--limit-images", type=int, default=64)
    ap.add_argument("--weights", help="backbone checkpoint (.npz/.pt/HF dir); "
                                      "default random init")
    ap.add_argument("--reference", default=os.environ.get("AIIC_REF", "."),
                    help="reference tree with dataset_images/ and interior_dataset.json "
                         "(default $AIIC_REF, else .)")
    ap.add_argument("--device", default=apply_platform_env(),
                    help="torch device (default $AIIC_PLATFORM, else cuda; cpu runs the plain "
                         "versions)")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    import torch

    from aiic_tpu_torch.data.native_loader import native_available
    from aiic_tpu_torch.engine import InteriorAnalyzer
    from aiic_tpu_torch.models.config import TINY_TEST, VIT_B_16, VIT_B_32, VIT_L_14
    from aiic_tpu_torch.serve.app import build_serving_app
    from aiic_tpu_torch.serve.db import InMemoryDB
    from aiic_tpu_torch.serve.metrics import GLOBAL_METRICS
    from aiic_tpu_torch.serve.rest import serve_forever_in_thread

    config = {"vit_b_16": VIT_B_16, "vit_b_32": VIT_B_32,
              "vit_l_14": VIT_L_14, "tiny": TINY_TEST}[args.model]

    ref = args.reference
    img_dir = os.path.join(ref, "dataset_images")
    payloads = _payloads(img_dir, args.limit_images)
    log(f"device={device} ({device_line(device)}); decoder: "
        f"{'native' if native_available() else 'the Python fallback (no native decoder built)'}")
    log(f"{len(payloads)} JPEG payloads, model={config.name}, "
        f"quantize={not args.no_quantize}, wire={args.wire}, "
        f"max_batch={args.max_batch}, max_wait_ms={args.max_wait_ms}, "
        f"pipeline_depth={args.pipeline_depth}")

    params = None
    if args.weights:
        from aiic_tpu_torch.models.init import load_clip_weights

        params = load_clip_weights(args.weights, config, device=device)
    t0 = time.perf_counter()
    analyzer = InteriorAnalyzer(
        params=params,
        dataset_json=os.path.join(ref, "interior_dataset.json"),
        config=config, dtype=torch.bfloat16,
        quantize=not args.no_quantize, wire_format=args.wire,
        max_batch=max(args.max_batch, 64),
        device=device,
    )
    log(f"engine built in {time.perf_counter() - t0:.1f}s")

    def make_app(max_wait_ms, pipeline_depth):
        server, batcher, warmed = build_serving_app(
            analyzer, db=InMemoryDB(), port=0,
            max_batch=args.max_batch, max_wait_ms=max_wait_ms,
            request_timeout=120.0, max_queue=4096,
            fast_decode=args.fast_decode, wire_format=args.wire,
            pipeline_depth=pipeline_depth,
            warm_buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
            warm_async=False, log=log,
        )
        serve_forever_in_thread(server)
        return server, batcher

    t0 = time.perf_counter()
    server, batcher = make_app(args.max_wait_ms, args.pipeline_depth)
    port = server.server_address[1]
    log(f"server warm on :{port} in {time.perf_counter() - t0:.1f}s")

    results = []
    try:
        client_counts = [int(c) for c in args.clients.split(",") if c]
        for clients in client_counts:
            per_client = max(args.per_client, 1)
            snap0 = GLOBAL_METRICS.snapshot()
            lats, wall, errs = run_load_point(port, payloads, clients, per_client)
            snap1 = GLOBAL_METRICS.snapshot()
            results.append(summarize(
                f"c{clients}", lats, wall, errs, clients, snap0, snap1,
                extra={"max_wait_ms": args.max_wait_ms,
                       "pipeline_depth": args.pipeline_depth}))

        if args.png_clients > 0:
            import io

            from PIL import Image

            png_payloads = []
            for b in payloads[:16]:  # PNG re-encode is slow; 16 rotate fine
                buf = io.BytesIO()
                Image.open(io.BytesIO(b)).convert("RGB").save(buf, "PNG")
                png_payloads.append(buf.getvalue())
            clients = args.png_clients
            snap0 = GLOBAL_METRICS.snapshot()
            lats, wall, errs = run_load_point(port, png_payloads, clients, args.per_client)
            snap1 = GLOBAL_METRICS.snapshot()
            results.append(summarize(
                f"png_c{clients}", lats, wall, errs, clients, snap0, snap1,
                extra={"corpus": "png", "max_wait_ms": args.max_wait_ms,
                       "pipeline_depth": args.pipeline_depth}))

        if args.batch_urls and os.path.isdir(img_dir):
            import functools
            from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

            class Quiet(SimpleHTTPRequestHandler):
                def log_message(self, *a):
                    pass

            src = ThreadingHTTPServer(
                ("127.0.0.1", 0), functools.partial(Quiet, directory=img_dir))
            threading.Thread(target=src.serve_forever, daemon=True).start()
            try:
                names = sorted(os.listdir(img_dir))[: args.limit_images]
                src_urls = [f"http://127.0.0.1:{src.server_address[1]}/{n}" for n in names]
                for nper in [int(x) for x in args.batch_urls.split(",") if x]:
                    bodies = []
                    for start in range(16):
                        chunk = [src_urls[(start + j) % len(src_urls)] for j in range(nper)]
                        bodies.append(json.dumps({"urls": chunk}).encode())
                    for clients in client_counts:
                        per_client = max(1, (args.per_client + nper - 1) // nper)
                        snap0 = GLOBAL_METRICS.snapshot()
                        lats, wall, errs, images_ok = run_batch_load_point(
                            port, bodies, clients, per_client)
                        snap1 = GLOBAL_METRICS.snapshot()
                        results.append(summarize(
                            f"urls{nper}_c{clients}", lats, wall, errs, clients,
                            snap0, snap1,
                            extra={"images_per_request": nper, "corpus": "urls",
                                   "img_per_s": round(images_ok / wall, 1),
                                   "max_wait_ms": args.max_wait_ms,
                                   "pipeline_depth": args.pipeline_depth}))
            finally:
                src.shutdown()
                src.server_close()

        for nper in [int(x) for x in args.batch_images.split(",") if x]:
            import base64

            # rotate the corpus across prebuilt bodies (b64 encode outside the
            # timed loop: it's client-side cost, identical for every protocol)
            bodies = []
            for start in range(0, max(len(payloads), 1)):
                chunk = [payloads[(start + j) % len(payloads)] for j in range(nper)]
                bodies.append(json.dumps({
                    "images_b64": [base64.b64encode(b).decode() for b in chunk]
                }).encode())
                if len(bodies) >= 16:
                    break
            for clients in client_counts:
                # hold total image count comparable to the single-image points
                per_client = max(1, (args.per_client + nper - 1) // nper)
                snap0 = GLOBAL_METRICS.snapshot()
                lats, wall, errs, images_ok = run_batch_load_point(
                    port, bodies, clients, per_client)
                snap1 = GLOBAL_METRICS.snapshot()
                results.append(summarize(
                    f"batch{nper}_c{clients}", lats, wall, errs, clients,
                    snap0, snap1,
                    extra={"images_per_request": nper,
                           "img_per_s": round(images_ok / wall, 1),
                           "max_wait_ms": args.max_wait_ms,
                           "pipeline_depth": args.pipeline_depth}))

        if args.sweep_wait:
            server.shutdown()
            batcher.close()
            server = None
            clients = client_counts[-1]
            for w in [float(x) for x in args.sweep_wait.split(",") if x]:
                server, batcher = make_app(w, args.pipeline_depth)
                port = server.server_address[1]
                snap0 = GLOBAL_METRICS.snapshot()
                lats, wall, errs = run_load_point(port, payloads, clients, args.per_client)
                snap1 = GLOBAL_METRICS.snapshot()
                results.append(summarize(
                    f"wait{w:g}", lats, wall, errs, clients, snap0, snap1,
                    extra={"max_wait_ms": w, "pipeline_depth": args.pipeline_depth}))
                server.shutdown()
                batcher.close()
                server = None
    finally:
        if server is not None:
            server.shutdown()
            batcher.close()

    best = max((r for r in results if "qps" in r and "img_per_s" not in r),
               key=lambda r: r["qps"], default=None)
    best_batch = max((r for r in results if "img_per_s" in r),
                     key=lambda r: r["img_per_s"], default=None)
    final = {
        "metric": "rest_serving_qps",
        "value": best["qps"] if best else 0.0,
        "unit": "req/s",
        "best_point": best,
    }
    if best_batch is not None:
        final["batch_img_per_s"] = best_batch["img_per_s"]
        final["best_batch_point"] = best_batch
    print(json.dumps(final), flush=True)
    return results + [final]


if __name__ == "__main__":
    main()
