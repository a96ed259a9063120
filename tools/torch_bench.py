#!/usr/bin/env python3
"""Batched inference throughput of the PyTorch port on one card — the twin
of ``bench.py``.

    python3 tools/torch_bench.py [batch] [iters] [--device cuda|cpu]

``batch`` defaults to 4096 and ``iters`` to 10, as in bench.py. Its
environment knobs, with its names and defaults:
``AIIC_BENCH_MODEL`` (``vit_b_16``; ``vit_b_32``, ``vit_l_14``,
``vit_l_14_336``, and ``tiny`` (TINY_TEST) for the tests),
``AIIC_BENCH_INT8`` (``2``: int8 MLP and attention projections, the serving
configuration; ``1`` int8 MLP only; ``0`` bf16) and ``AIIC_WIRE``
(``patch``, the patch-major uint8 wire; ``hwc``). ``--device`` (default
``$AIIC_PLATFORM``, else ``cuda``) takes the place of JAX's platform: without
a card and without ``--device cpu`` the tool exits.

The classify program (``engine/programs.classify_batch``,
``attn_impl="auto"``) is called directly, as bench.py calls its jitted
program: the engine's 512-row cap does not apply. Seeded random weights are
cast to bf16 before quantizing, the detector and category text features
come from ``np.random.default_rng(0)`` in bench.py's order. Five legs:

1. device-resident batches, each call synced on its scalar;
2. device-resident with 3 calls in flight (the headline value): each call's
   scalar is copied ``non_blocking`` into pinned host memory behind a CUDA
   event and the oldest event is waited on (``.item()`` on the oldest
   scalar would queue its copy behind the newer calls and sync on all);
3. host uint8 batches copied as the engine copies them (pageable memory,
   ``non_blocking``: the copy blocks the host), pipelined;
4. the single-image latency, p50 of 20 synced calls;
5. a null program's round trip (one elementwise launch and a 4-byte copy
   back): ``p50_device_ms = max(p50_ms - rtt, 0)``.

Prints bench.py's one JSON line (``metric``, ``value``, ``unit``,
``vs_baseline``, ``p50_ms``, ``p50_device_ms``); ``vs_baseline`` is the
rounded value / 5000 (bench.py divides the unrounded rate: at most 1e-4
apart). The card's name and power limit, each leg and the peak device memory
go to stderr. ``main(argv)`` returns the printed records.
"""

import argparse
import json
import os
import sys
import time
from collections import deque

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

MODELS = ("vit_b_16", "vit_b_32", "vit_l_14", "vit_l_14_336", "tiny")
IN_FLIGHT = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def setup(model: str, int8_level: str, wire: str, device, rng: np.random.Generator) -> dict:
    """bench.py's program on ``device``: ``config``, ``classify(pixels) ->
    (out, sync scalar)`` and ``make_batch(n)`` (uint8 on the wire, from
    ``rng`` after the text features, in bench.py's order)."""
    import torch

    from aiic_tpu_torch.engine.detector import DETECTOR_CATEGORIES, INTERIOR_COUNT
    from aiic_tpu_torch.engine.programs import classify_batch
    from aiic_tpu_torch.models import config as configs
    from aiic_tpu_torch.models.init import init_clip_params, tree_map

    config = getattr(configs, "TINY_TEST" if model == "tiny" else model.upper())
    params = init_clip_params(config, torch.Generator(device=device).manual_seed(0),
                              device=device)
    params = tree_map(lambda t: t.to(torch.bfloat16), params)
    if int8_level == "1":
        from aiic_tpu_torch.ops.quant import quantize_model_mlp

        params = quantize_model_mlp(params)
        log("int8 MLP weights active")
    elif int8_level != "0":
        from aiic_tpu_torch.ops.quant import quantize_model

        params = quantize_model(params)
        log("int8 MLP + attention-projection weights active "
            "(AIIC_BENCH_INT8=0 bf16, =1 MLP-only)")

    det_text = rng.standard_normal((len(DETECTOR_CATEGORIES), config.embed_dim)).astype(
        np.float32)
    det_text /= np.linalg.norm(det_text, axis=-1, keepdims=True)
    det_text = torch.from_numpy(det_text).to(device)
    cat_text = torch.from_numpy(
        rng.standard_normal((5, 304, config.embed_dim)).astype(np.float32)).to(device)
    cat_mask = torch.ones((5, 304), dtype=torch.bool, device=device)

    @torch.inference_mode()
    def classify(pixels):
        out = classify_batch(params, pixels, det_text, cat_text, cat_mask, config=config,
                             interior_count=INTERIOR_COUNT, dtype=torch.bfloat16,
                             attn_impl="auto")
        # a reduced scalar: fetching it waits for the whole call
        return out, (out["interior_mass"].sum() + out["topk_vals"].sum()).float()

    size = config.image_size
    if wire == "patch":
        from aiic_tpu_torch.ops.preprocess import to_patch_major

        log("patch-major uint8 wire format active (AIIC_WIRE=hwc for the HWC wire)")

        def make_batch(n):
            hwc = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
            return to_patch_major(hwc, config.patch_size)
    else:
        def make_batch(n):
            return rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)

    return {"config": config, "classify": classify, "make_batch": make_batch}


# The same rows in a larger call: block_cls's products take M = B, so the
# scores agree closely, not bit for bit.
ROW_TOL = 1e-3
SCORES = ("interior_mass", "non_interior_mass", "top_conf", "topk_vals")


def row_agreement(big: dict, small: dict) -> dict:
    """The first rows of a larger call against the same rows called alone:
    the verdicts (the engine's detector rule and top category), the top-5
    of every category, and the largest score difference, held at
    ``ROW_TOL`` (``ok``)."""
    import torch

    from aiic_tpu_torch.engine.detector import DEFAULT_CONFIDENCE_THRESHOLD

    n = small["top_idx"].shape[0]

    def verdicts(out):
        interior = ((out["interior_mass"][:n] > out["non_interior_mass"][:n])
                    & (out["top_conf"][:n] > DEFAULT_CONFIDENCE_THRESHOLD))
        return torch.stack([interior.long(), out["top_idx"][:n].long()]).cpu()

    same_verdicts = torch.equal(verdicts(big), verdicts(small))
    same_top5 = torch.equal(big["topk_idx"][:n].cpu(), small["topk_idx"].cpu())
    diff = max(float((big[k][:n].float() - small[k].float()).abs().max()) for k in SCORES)
    finite = all(bool(torch.isfinite(big[k].float()).all()) for k in SCORES)
    return {"rows": n, "of": big["top_idx"].shape[0], "verdicts_equal": same_verdicts,
            "top5_equal": same_top5, "max_score_diff": diff, "finite": finite,
            "ok": same_verdicts and same_top5 and finite and diff <= ROW_TOL}


class _Fetches:
    """Scalars fetched without serialising the stream: on the card each is
    copied into a slot of pinned host memory and an event recorded after
    the copy; ``get`` waits on that event alone. On the CPU the scalar is
    read as it is."""

    def __init__(self, device, slots: int):
        import torch

        self.cuda = device.type == "cuda"
        self.host = (torch.zeros(slots, dtype=torch.float32, pin_memory=True)
                     if self.cuda else None)
        self.next = 0

    def put(self, scalar):
        if not self.cuda:
            return scalar
        import torch

        slot = self.next % len(self.host)
        self.next += 1
        self.host[slot].copy_(scalar, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return event, slot

    def get(self, handle) -> float:
        if not self.cuda:
            return float(handle)
        event, slot = handle
        event.synchronize()
        return float(self.host[slot])


def main(argv=None) -> list:
    from aiic_tpu_torch.utils.platform import apply_platform_env, device_line, require_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=4096)
    ap.add_argument("iters", nargs="?", type=int, default=10)
    ap.add_argument("--device", default=apply_platform_env(),
                    help="torch device (default $AIIC_PLATFORM, else cuda; cpu runs the plain "
                         "versions)")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    import torch

    model = os.environ.get("AIIC_BENCH_MODEL", "vit_b_16")
    if model not in MODELS:
        raise SystemExit(f"AIIC_BENCH_MODEL={model!r}: one of {MODELS}")
    int8_level = os.environ.get("AIIC_BENCH_INT8", "2")
    wire = os.environ.get("AIIC_WIRE", "patch")
    batch, iters = args.batch, args.iters
    rng = np.random.default_rng(0)
    bench = setup(model, int8_level, wire, device, rng)
    if device.type == "cuda":  # the peak from here on, the weights counted
        torch.cuda.reset_peak_memory_stats(device)
    classify, make_batch = bench["classify"], bench["make_batch"]
    log(f"device={device} ({device_line(device)}) torch {torch.__version__} "
        f"batch={batch} model={bench['config'].name}")

    def sync(pixels) -> float:
        return float(classify(pixels)[1])

    # --- device-resident throughput (headline: the card's compute) -------
    dev_batches = [torch.from_numpy(make_batch(batch)).to(device) for _ in range(4)]
    t0 = time.perf_counter()
    sync(dev_batches[0])
    log(f"first call: {time.perf_counter() - t0:.1f}s")
    for b in dev_batches:
        sync(b)

    t0 = time.perf_counter()
    for i in range(iters):
        sync(dev_batches[i % 4])
    dt = time.perf_counter() - t0
    log(f"device-resident synced: {iters}x{batch} in {dt:.3f}s -> {batch * iters / dt:.1f} img/s")

    # IN_FLIGHT calls queued, the oldest fetched as each new one is queued
    fetches = _Fetches(device, 2 * IN_FLIGHT)
    pend = deque(fetches.put(classify(dev_batches[i % 4])[1]) for i in range(IN_FLIGHT))
    t0 = time.perf_counter()
    for i in range(2 * iters):
        pend.append(fetches.put(classify(dev_batches[i % 4])[1]))
        fetches.get(pend.popleft())
    dt = time.perf_counter() - t0
    ips_device = batch * 2 * iters / dt
    for handle in pend:
        fetches.get(handle)
    log(f"device-resident pipelined ({IN_FLIGHT} in flight, event-waited): {2 * iters}x{batch} "
        f"in {dt:.3f}s -> {ips_device:.1f} img/s")
    del dev_batches

    # --- host uint8 batches, pipelined -----------------------------------
    h_iters = max(2, min(iters, (10 * 1024) // batch))
    host_batches = [make_batch(batch) for _ in range(4)]
    log("host leg: each batch copied as the engine copies it (torch.from_numpy(...).to(device, "
        "non_blocking=True) from pageable memory): the copy blocks the host")

    def upload(a):
        return torch.from_numpy(a).to(device, non_blocking=True)

    sync(upload(host_batches[0]))
    t0 = time.perf_counter()
    scalars = [classify(upload(host_batches[i % 4]))[1] for i in range(h_iters)]
    for s in scalars:
        float(s)
    dt = time.perf_counter() - t0
    log(f"host-uint8 pipelined: {h_iters}x{batch} in {dt:.3f}s -> {batch * h_iters / dt:.1f} "
        "img/s")
    del host_batches, scalars

    # --- p50 single-image latency ----------------------------------------
    one = torch.from_numpy(make_batch(1)).to(device)
    sync(one)
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        sync(one)
        lat.append(time.perf_counter() - t0)
    lat.sort()
    p50_ms = lat[len(lat) // 2] * 1e3
    log(f"p50 single-image latency: {p50_ms:.3f} ms (p90 {lat[int(len(lat) * 0.9)] * 1e3:.3f} ms)")

    # the null program: one elementwise launch and the scalar's copy back
    tiny = torch.zeros((), device=device)
    float(tiny * 2.0 + 1.0)
    rtts = []
    for _ in range(20):
        t0 = time.perf_counter()
        float(tiny * 2.0 + 1.0)
        rtts.append(time.perf_counter() - t0)
    rtts.sort()
    rtt_ms = rtts[len(rtts) // 2] * 1e3
    p50_device_ms = max(p50_ms - rtt_ms, 0.0)
    log(f"p50 split: {p50_ms:.3f} ms = launch+copy round trip {rtt_ms:.4f} ms + device "
        f"~{p50_device_ms:.3f} ms")
    if device.type == "cuda":
        log(f"peak device memory: {torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB")

    value = round(ips_device, 1)
    rec = {
        "metric": "images_per_sec_per_chip",
        "value": value,
        "unit": "img/s",
        "vs_baseline": round(value / 5000.0, 4),
        "p50_ms": round(p50_ms, 1),
        "p50_device_ms": round(p50_device_ms, 1),
    }
    print(json.dumps(rec), flush=True)
    return [rec]


if __name__ == "__main__":
    main()
