"""REST readiness smoke of the PyTorch port, the twin of ``tools/rest_smoke.py``:
start ``python -m aiic_tpu_torch.cli.worker --serve``, poll ``/health`` and
``/ready``, and time the first ``POST /analyze`` after readiness (the warmup
ran every bucket, so it must not stall), five more, and one four-image
``POST /analyze-batch``; check the reference result schema, ``/dead-letters``
and ``/metrics``. Prints one JSON line with the JAX tool's field names.

    python tools/torch_rest_smoke.py [port] --dataset-json D --sample IMG [worker args...]

e.g. ``python tools/torch_rest_smoke.py 3378 --dataset-json d.json --sample s.jpg
--quantize --dtype bfloat16 --wire-format patch`` drives the int8 serving
configuration through the REST surface. Arguments it does not know go to
the worker (``--device cpu`` runs the plain versions). The server is
stopped with SIGTERM.
"""

import argparse
import base64
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("port", nargs="?", type=int, default=3377)
    ap.add_argument("--dataset-json", required=True, help="the worker's vocabulary")
    ap.add_argument("--sample", required=True, help="the image the requests send")
    args, extra = ap.parse_known_args()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "aiic_tpu_torch.cli.worker", "--serve",
         "--port", str(args.port), "--dataset-json", args.dataset_json, *extra],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    base = f"http://127.0.0.1:{args.port}"
    try:
        # liveness first (the server binds once the engine is built)
        t0 = time.time()
        while True:
            try:
                urllib.request.urlopen(base + "/health", timeout=2)
                break
            except Exception:
                if proc.poll() is not None:
                    raise RuntimeError(f"server died rc={proc.returncode}")
                if time.time() - t0 > 420:
                    raise RuntimeError("server never became live")
                time.sleep(0.5)
        live_after = time.time() - t0

        # readiness flips when the warmup has run every bucket
        ready_wait_t0 = time.time()
        while True:
            try:
                with urllib.request.urlopen(base + "/ready", timeout=5) as r:
                    if json.loads(r.read().decode()).get("ready"):
                        break
            except urllib.error.HTTPError as e:
                if e.code != 503:
                    raise
            except Exception:
                pass
            if proc.poll() is not None:
                raise RuntimeError(f"server died rc={proc.returncode}")
            if time.time() - ready_wait_t0 > 900:
                raise RuntimeError("server never became ready")
            time.sleep(1.0)
        ready_after = time.time() - ready_wait_t0

        with open(args.sample, "rb") as f:
            img = f.read()
        req = urllib.request.Request(base + "/analyze", data=img, method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read().decode())
        first_ms = (time.perf_counter() - t0) * 1e3

        # a few more for a steady p50
        lats = []
        for _ in range(5):
            t0 = time.perf_counter()
            urllib.request.urlopen(
                urllib.request.Request(base + "/analyze", data=img, method="POST"),
                timeout=60,
            ).read()
            lats.append((time.perf_counter() - t0) * 1e3)
        lats.sort()

        # the batch protocol: one POST carries several images
        breq = urllib.request.Request(
            base + "/analyze-batch",
            data=json.dumps({"images_b64": [base64.b64encode(img).decode()] * 4}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(breq, timeout=60) as r:
            batch_out = json.loads(r.read().decode())["results"]
        batch_ms = (time.perf_counter() - t0) * 1e3
        full_keys = {"is_interior", "interior_confidence", "detected_category",
                     "analysis", "reason"}
        schema_ok = (set(out) == full_keys
                     and all(set(r) == full_keys for r in batch_out))

        with urllib.request.urlopen(base + "/dead-letters", timeout=10) as r:
            dl = json.loads(r.read().decode())

        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            metrics = json.loads(r.read().decode())
        stages = {k: v for k, v in metrics.items() if k.startswith("stage_")}

        print(json.dumps({
            "metric": "rest_first_request_after_ready_ms",
            "value": round(first_ms, 1),
            "live_after_s": round(live_after, 1),
            "ready_after_s": round(ready_after, 1),
            "steady_p50_ms": round(lats[len(lats) // 2], 1),
            "no_cold_start_stall": first_ms < 5000.0,
            "is_interior": out.get("is_interior"),
            "batch_results": len(batch_out),
            "batch_ms": round(batch_ms, 1),
            "full_reference_schema": schema_ok,
            "dead_letters_queryable": "dead_letters" in dl,
            "latency_quantiles_present": "analyze_p50_ms" in metrics,
            "stage_timings": stages,
            "stages_present": any(k.startswith("stage_serve_decode") for k in stages)
            and any(k.startswith("stage_dispatch") for k in stages),
        }))
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            print("WARNING: server did not exit on SIGTERM", file=sys.stderr)


if __name__ == "__main__":
    main()
