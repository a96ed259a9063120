#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's classify path on one CUDA card.

    python3 tools/torch_profile.py [--batch 256] [--iters 3]

Builds the ViT-B/16 int8 ``aiic_tpu_torch`` engine from a seeded init, warms
``classify_pixels`` at one batch size, then:

- times the host stages of one request (patch-major repack, host-to-device
  copy) and the whole call with the host clock;
- traces ``--iters`` calls with ``torch.profiler`` and sums device time by
  kernel group (the two Hopper kernels' launches, cuBLAS/other GEMMs,
  elementwise, copies), with the device's busy and idle share of the wall
  time.

Prints one JSON line; writes the chrome trace and the full kernel table to
``chiprun_out/``. Needs a CUDA card; fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

GROUPS = [  # (group, substring of the CUDA kernel name), first match wins
    ("attn_core", "attn_core_kernel"),
    ("int8_gemm_qkv", "EpiQKV"),
    ("bf16_gemm_out_proj", "EpiOutProj"),
    ("int8_gemm_c_fc_gelu", "EpiGelu"),
    ("int8_gemm_c_proj", "EpiResidual"),
    ("row_quant_ln", "rowquant_kernel"),
    ("memcpy", "Memcpy"),
    ("memset", "Memset"),
    ("other_gemm", "gemm"),
    ("other_gemm", "sm90_"),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: needs a CUDA card")
    from chip_smoke import TRAINING_DATA
    from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer
    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.ops.preprocess import to_patch_major

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    engine = InteriorAnalyzer(None, VIT_B_16, training_data=TRAINING_DATA, device="cuda")
    size = VIT_B_16.image_size
    px = np.random.default_rng(0).integers(0, 256, (args.batch, size, size, 3), dtype=np.uint8)
    engine.classify_pixels(px)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    pm = to_patch_major(px, VIT_B_16.patch_size)
    repack_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    torch.from_numpy(pm).to("cuda")
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    for _ in range(args.iters):
        engine.classify_pixels(px)
    call_ms = (time.perf_counter() - t0) * 1e3 / args.iters

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            engine.classify_pixels(px)
        torch.cuda.synchronize()
        traced_wall_ms = (time.perf_counter() - t0) * 1e3

    groups: dict = {}
    busy_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.self_device_time_total
        busy_us += us
        name = next((g for g, key in GROUPS if key in ev.key), "elementwise_and_other")
        groups[name] = groups.get(name, 0.0) + us / 1e3 / args.iters
    if busy_us == 0:
        raise SystemExit("torch_profile: the trace shows no device time")
    busy_ms = busy_us / 1e3 / args.iters
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "torch_profile_trace.json"))
    with open(os.path.join(out_dir, "torch_profile_kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    wall = traced_wall_ms / args.iters
    print(json.dumps({
        "card": card, "batch": args.batch, "call_ms": call_ms,
        "images_per_s": args.batch / call_ms * 1e3,
        "host_repack_ms": repack_ms, "host_to_device_ms": h2d_ms,
        "traced_call_ms": wall, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1 - busy_ms / wall),
        "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
