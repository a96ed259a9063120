#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's classify path on one CUDA card.

    python3 tools/torch_profile.py [--config int8|bf16|fp32] [--attn-impl pallas|pallas_mlp]
                                   [--model vit_b_16|vit_b_32|vit_l_14|vit_l_14_336]
                                   [--batch 256] [--iters 3]
    python3 tools/torch_profile.py --train fp32_auto|fp32_block_fused|bf16_block_fused|int8_text
                                   [--batch 256] [--iters 3]

Builds an ``aiic_tpu_torch`` engine (``--model``, ViT-B/16 by default) from
a seeded init in one of the
serving configurations (``int8``: bf16 with int8 weights on the patch-major
wire, the default; ``bf16``: bf16 without int8 weights, the worker's default;
``fp32``: the batch CLI's default; the last two on the HWC uint8 wire), warms
``classify_pixels`` at one batch size, then:

- times the host stages of one request (the patch-major repack where that
  wire is used, the host-to-device copy) and the whole call with the host
  clock;
- traces ``--iters`` calls with ``torch.profiler`` and sums device time by
  kernel group (the Hopper kernels' launches by stage, cuBLAS GEMMs,
  elementwise, copies), with the device's busy and idle share of the wall
  time.

With ``--train PATH`` it profiles the LoRA trainer's step instead: a
seeded ViT-B/16, ``make_train_step`` with cached image features and
``--batch`` dense text rows (so the text tower sees every row), on one of
``chip_smoke.py``'s training paths; host time per step, then device time by
kernel group (the text-block kernels' launches by stage, cuBLAS, autograd
elementwise work).

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
    ("block_int8_gemm_fwd", "EpiQkv8"),
    ("block_int8_gemm_fwd", "EpiFc8"),
    ("block_int8_gemm_fwd", "EpiY8"),
    ("block_int8_gemm_bwd", "EpiDfq8"),
    ("block_int8_gemm_bwd", "EpiDh2"),
    ("block_int8_gemm_bwd", "EpiChunkPart"),
    ("block_int8_gemm_bwd", "EpiRowScale"),
    ("block_row_quant", "rowquant_scaled_kernel"),
    ("block_row_quant", "ln_rowquant_kernel"),
    ("block_core_fwd", "block_core_fwd_kernel"),
    ("block_core_bwd", "block_core_bwd_kernel"),
    ("block_simt_gemm_backbone", "sgemm_kernel"),
    ("block_simt_gemm_rank_r", "simt_gemm_kernel<64"),
    ("block_rank_r_sums", "sum_partials_kernel"),
    ("block_ln_fwd", "ln_fwd_rows_kernel"),
    ("block_ln_bwd", "ln_bwd_rows_kernel"),
    ("attn_core_mma", "attn_core_mma_kernel"),  # rows 6-7 (bf16) and 8, tensor cores
    ("attn_core_bwd_mma", "core_bwd_mma_"),  # row 9 (bf16), tensor cores
    ("attn_core_f32", "attn_core_f32_kernel"),  # rows 6-7 (fp32), register-tiled
    ("attn_core_fp32", "attn_core_kernel<float"),
    ("attn_core_bf16", "attn_core_kernel"),
    ("int8_gemm_qkv", "EpiQKV"),
    ("bf16_gemm_qkv", "EpiBiasQKV"),
    ("bf16_gemm_out_proj", "EpiOutProj"),
    ("int8_gemm_c_fc_gelu", "EpiGelu"),
    ("int8_gemm_c_proj", "EpiResidual"),
    ("int8_gemm_c_proj_chunked", "EpiMlpChunk"),
    ("int8_mlp_chunk_sum", "mlp_chunk_sum_kernel"),
    ("bf16_gemm_c_fc_gelu", "EpiBiasGelu"),
    ("bf16_gemm_c_proj", "EpiMlpOut"),
    ("block_wmma_gemm_bf16", "gemm_kernel<__nv_bfloat16"),
    ("row_quant_ln", "rowquant_kernel"),
    ("row_ln_bf16", "ln_rows_kernel"),
    ("memcpy", "Memcpy"),
    ("memset", "Memset"),
    ("cublas_gemm", "nvjet"),
    ("cublas_gemm", "gemm"),
    ("cublas_gemm", "sm90_"),
]
MODELS = {"vit_b_16": "VIT_B_16", "vit_b_32": "VIT_B_32", "vit_l_14": "VIT_L_14",
          "vit_l_14_336": "VIT_L_14_336"}
CONFIGS = {  # engine options of each serving configuration
    "int8": dict(dtype="bfloat16", quantize=True, wire_format="patch"),
    "bf16": dict(dtype="bfloat16", quantize=False, wire_format="hwc"),
    "fp32": dict(dtype="float32", quantize=False, wire_format="hwc"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="int8")
    ap.add_argument("--attn-impl", choices=["pallas", "pallas_mlp"], default="pallas")
    ap.add_argument("--model", choices=sorted(MODELS), default="vit_b_16")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--train", choices=["fp32_auto", "fp32_block_fused", "bf16_block_fused",
                                        "int8_text"],
                    help="profile the LoRA train step on this path instead of serving")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: needs a CUDA card")
    if args.train:
        return profile_train(args)
    from chip_smoke import TRAINING_DATA
    from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer
    from aiic_tpu_torch.models import config as configs
    from aiic_tpu_torch.ops.preprocess import to_patch_major

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    opts = dict(CONFIGS[args.config])
    opts["dtype"] = getattr(torch, opts["dtype"])
    model = getattr(configs, MODELS[args.model])
    engine = InteriorAnalyzer(None, model, training_data=TRAINING_DATA, device="cuda",
                              attn_impl=args.attn_impl, **opts)
    size = model.image_size
    px = np.random.default_rng(0).integers(0, 256, (args.batch, size, size, 3), dtype=np.uint8)
    engine.classify_pixels(px)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    wire = to_patch_major(px, model.patch_size) if opts["wire_format"] == "patch" else px
    repack_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    torch.from_numpy(wire).to("cuda")
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    for _ in range(args.iters):
        engine.classify_pixels(px)
    call_ms = (time.perf_counter() - t0) * 1e3 / args.iters

    traced = _trace(lambda: engine.classify_pixels(px), args.iters,
                    f"{args.model}_{args.config}_{args.attn_impl}_b{args.batch}")
    print(json.dumps({
        "card": card, "model": model.name, "config": args.config, "attn_impl": args.attn_impl,
        "batch": args.batch, "call_ms": call_ms,
        "images_per_s": args.batch / call_ms * 1e3,
        "host_repack_ms": repack_ms, "host_to_device_ms": h2d_ms, **traced,
    }), flush=True)
    return 0


def _trace(fn, iters: int, tag: str) -> dict:
    """Trace ``iters`` calls of fn; device ms per call by kernel group."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
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
        groups[name] = groups.get(name, 0.0) + us / 1e3 / iters
    if busy_us == 0:
        raise SystemExit("torch_profile: the trace shows no device time")
    busy_ms = busy_us / 1e3 / iters
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"torch_profile_trace_{tag}.json"))
    with open(os.path.join(out_dir, f"torch_profile_kernels_{tag}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    wall = traced_wall_ms / iters
    return {"traced_call_ms": wall, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / wall),
            "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}


def profile_train(args) -> int:
    """The LoRA train step on one training path (cached image features,
    ``--batch`` dense text rows), profiled as the serving call is."""
    import torch

    from chip_smoke import TRAIN_PATHS, _lora_init, _path_params, _step_batch, _train_config
    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.models.init import init_clip_params
    from aiic_tpu_torch.train import make_optimizer, make_train_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    opts, impl = TRAIN_PATHS[args.train]
    params = _path_params(init_clip_params(VIT_B_16, torch.Generator(device="cuda").manual_seed(0),
                                           device="cuda"), opts)
    rng = np.random.default_rng(0)
    feats, tokens = _step_batch(rng, args.batch, "cuda")
    cfg = _train_config(opts, epochs=2, batch_size=args.batch)
    opt = make_optimizer(cfg, steps_per_epoch=4)
    step, _ = make_train_step(VIT_B_16, cfg, opt, cached_image=True, device="cuda")
    state = {"lora": _lora_init(rng, "cuda")}
    state["opt"] = opt.init(state["lora"])

    def one_step():
        loss, state["lora"], state["opt"] = step(params, state["lora"], state["opt"], feats,
                                                 tokens)
        return float(loss)

    one_step()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        one_step()
    step_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    traced = _trace(one_step, args.iters, f"train_{args.train}_b{args.batch}")
    print(json.dumps({"card": card, "train": args.train, "text_impl": impl,
                      "batch": args.batch, "step_ms": step_ms,
                      "images_per_s": args.batch / step_ms * 1e3, **traced}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
