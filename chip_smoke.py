#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``aiic_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each of which raises (and so exits non-zero) on failure:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. the Hopper kernels built with nvcc from ``aiic_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the
   serving paths' shapes (ViT-B/16 image and text half-blocks, B=1, an odd
   B, and an all-zero LN row); the packed-QKV core in fp32 and bf16;
4. the paths: four full-width ViT-B/16 ``InteriorAnalyzer`` engines from
   one seeded init (int8 serving on the patch wire; bf16 unquantized, the
   worker's default; bf16 with ``attn_impl="pallas_mlp"``; fp32, the batch
   CLI's default; the last three on the HWC uint8 wire), each answering
   requests of 1, 7 and 64 images with every kernel's launch count set to 0
   before and checked exactly after;
5. the same weights and 4 images through the int8 and the bf16 unquantized
   engines on the CPU (plain path): feature cosine, verdicts and top-1
   categories against the card;
6. the whole-text-block kernels of training (``text_block_fwd``,
   ``text_block_bwd``) against their plain versions at the B/16 text shape
   (S=77, W=512, M=2048, H=8, rank 16, causal mask, nonzero LoRA B) for
   B = 1, 7, 64 in fp32 and bf16; their int8 twins (``text_block_fwd_int8``,
   ``text_block_bwd_int8``) on per-channel-quantized weights at the same
   shape (unchunked plan) and at the L/14 text width (W=768, M=3072, H=12,
   B=7, the chunked plan);
7. the LoRA trainer at full ViT-B/16 width through ``train_lora``, 2 epochs
   at batch 16 on a synthetic dataset of random 256x256 PNGs written to a
   temporary directory, on four paths: fp32 ``auto`` (which resolves to
   ``pallas_vjp``), fp32 ``block_fused``, bf16 ``block_fused`` and
   ``int8_text`` (``--attn-impl block_fused --quantize-text
   --quantize-image``: the int8 whole-block kernels), each with every launch
   count set to 0 before and checked exactly after; the loss finite, adapter
   B moved off zero, the ``.pth`` in the reference layout;
8. one train step of each path on the card against the same step on the CPU
   (plain versions), and ``block_fused`` against ``xla`` on the card; two
   int8 ``use_lora`` engines (the ``int8_text`` adapters of phase 7 at rank
   16; a seeded rank-4 ``c_fc``/``c_proj`` checkpoint, the analyzer's
   default) answering 1, 7 and 64 images with exact launch counts, their
   text features moved by the adapter and held against their CPU runs;
9. timings: each kernel against its plain version (serving kernels at B=256
   image rows, the text-block kernels at B=256 text rows in fp32, bf16 and
   int8), with its bound (and the packed core against
   ``scaled_dot_product_attention``); classify images/s at B=256 and
   single-image p50 latency of the int8 and the bf16 unquantized engines;
   train-step ms at batch 256 (cached image features, dense text rows) on
   the four training paths; the steady-state images/s of a ``train_lora``
   epoch.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. A longer report goes to
``chiprun_out/chip_smoke.json``.
No JAX is imported; nothing falls back to the CPU when CUDA is missing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPORT: dict = {}
T0 = time.perf_counter()

# A kernel agrees with its plain version when every row's cosine is at least
# COS_MIN and at least ULP_SHARE of the elements lie within 2 bf16 ULPs of the
# plain value: the two differ only where a summation order moves an fp32
# value across a bf16 or int8 rounding boundary.
# In fp32 a kernel agrees when max |kernel - plain| / max(|plain|, 1) is at
# most F32_REL: only the order of fp32 sums differs.
# The text-block kernels (training) round eleven intermediates to bf16 on
# the way from x to y or dx (qkv, p, a, h2, u; dfq, dy1, da, ds, dqkv and the
# rank-r products); where a later sum cancels, a flipped rounding upstream
# costs a few ULPs of the terms, not of the smaller result. Their bf16 bar is
# therefore per row: cosine >= COS_MIN and every element within 2 bf16 ULPs
# of the row's largest |plain| value.
# The int8 text-block kernels (training in the int8 serving numerics) are
# held to the same per-row bar for y; dx to a row cosine >= COS_MIN alone: an
# int8 quantum that flips between kernel and plain (their fp32 LN and core
# sums differ in order, so one activation can round to the other integer)
# moves a whole row of a cotangent product by that quantum's weight row, a
# cancellation-free shift far above 2 ULPs of small dx entries but a few
# 1e-6 of the row's cosine; each LoRA cotangent to a cosine >= COS_MIN.
COS_MIN = 0.9999
ULP_SHARE = 0.99
F32_REL = 1e-5

KERNELS = {
    "int8_ln_qkv_attention": {
        "source": "aiic_tpu_torch/csrc/int8_attention.cu",
        "replaces": "aiic_tpu/ops/quant.py:353",
    },
    "int8_ln_mlp": {
        "source": "aiic_tpu_torch/csrc/int8_mlp.cu",
        "replaces": "aiic_tpu/ops/quant.py:102",
    },
    "fused_ln_qkv_attention": {
        "source": "aiic_tpu_torch/csrc/ln_qkv_attention.cu",
        "replaces": "aiic_tpu/ops/attention.py:133",
    },
    "fused_attention_qkv": {
        "source": "aiic_tpu_torch/csrc/attention_qkv.cu",
        "replaces": "aiic_tpu/ops/attention.py:426",
    },
    "fused_ln_mlp": {
        "source": "aiic_tpu_torch/csrc/ln_mlp.cu",
        "replaces": "aiic_tpu/ops/mlp.py:27",
    },
    "text_block_fwd": {
        "source": "aiic_tpu_torch/csrc/text_block.cuh",
        "replaces": "aiic_tpu/ops/block_grad.py:322 and :388",
    },
    "text_block_bwd": {
        "source": "aiic_tpu_torch/csrc/text_block.cuh",
        "replaces": "aiic_tpu/ops/block_grad.py:198 and :472",
    },
    "text_block_fwd_int8": {
        "source": "aiic_tpu_torch/csrc/text_block_int8.cu",
        "replaces": "aiic_tpu/ops/block_grad.py:1084 and :1433",
    },
    "text_block_bwd_int8": {
        "source": "aiic_tpu_torch/csrc/text_block_int8.cu",
        "replaces": "aiic_tpu/ops/block_grad.py:1104 and :1542",
    },
}

# NVIDIA H100 SXM5 data sheet: dense peaks by operand type, and HBM3.
PEAK_OPS = {"bf16": 989.4e12, "int8": 1978.9e12, "fp32": 66.9e12}
HBM_BYTES_PER_S = 3.35e12

# The paths of phase 4: engine options, and the kernels each runs.
PATHS = {
    "int8": (dict(dtype="bfloat16", quantize=True, wire_format="patch", attn_impl="pallas"),
             ("int8_ln_qkv_attention", "int8_ln_mlp")),
    "bf16": (dict(dtype="bfloat16", quantize=False, wire_format="hwc", attn_impl="pallas"),
             ("fused_ln_qkv_attention",)),
    "bf16_pallas_mlp": (dict(dtype="bfloat16", quantize=False, wire_format="hwc",
                             attn_impl="pallas_mlp"), ("fused_ln_qkv_attention", "fused_ln_mlp")),
    "fp32": (dict(dtype="float32", quantize=False, wire_format="hwc", attn_impl="pallas"),
             ("fused_attention_qkv",)),
}

# The vocabulary of tests/test_engine.py's engine fixture.
TRAINING_DATA = [
    {"image_path": "x.jpg", "style": "nowoczesny",
     "characteristics": ["czyste linie", "przestronne"], "materials": ["drewno"],
     "colors": ["biały", "szary"], "room_type": "kuchnia"},
    {"image_path": "y.jpg", "style": "klasyczny", "characteristics": ["eleganckie"],
     "materials": ["marmur"], "colors": ["beżowy"], "room_type": "salon"},
]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _half_block_inputs(rng, bsz, seq, width, heads, *, mask, zero_row, device):
    import torch

    from aiic_tpu_torch.models.clip import causal_mask
    from aiic_tpu_torch.ops.quant import quantize_weight

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dtype)

    mlp = 4 * width
    x = rng.standard_normal((bsz, seq, width))
    ln_b = 0.1 * rng.standard_normal(width)
    if zero_row:  # all-zero LN output row: exercises the 1e-6 scale floor
        x[0, 0] = 0.0
        ln_b[:] = 0.0
    proj_std = width ** -0.5 * 24 ** -0.5
    p = {
        "x": t(x, torch.bfloat16),
        "ln_s": t(1 + 0.1 * rng.standard_normal(width)),
        "ln_b": t(ln_b),
        "wqkv": t(rng.standard_normal((width, 3 * width)) * width ** -0.5),
        "bqkv": t(0.1 * rng.standard_normal(3 * width)),
        "wo": t(rng.standard_normal((width, width)) * proj_std, torch.bfloat16),
        "bo": t(0.1 * rng.standard_normal(width)),
        "w1": t(rng.standard_normal((width, mlp)) * (2 * width) ** -0.5),
        "b1": t(0.1 * rng.standard_normal(mlp)),
        "w2": t(rng.standard_normal((mlp, width)) * proj_std),
        "b2": t(0.1 * rng.standard_normal(width)),
        "mask": causal_mask(seq, device=device) if mask else None,
        "heads": heads,
    }
    p["wqkv_q"], p["sqkv"] = quantize_weight(p["wqkv"])
    p["w1_q"], p["s1"] = quantize_weight(p["w1"])
    p["w2_q"], p["s2"] = quantize_weight(p["w2"])
    for k in ("wqkv", "w1", "w2"):  # the bf16 kernels' weights, cast once
        p[k + "_b"] = p[k].to(torch.bfloat16)
    p["qkv"] = t(rng.standard_normal((bsz, seq, 3 * width)))
    p["qkv_b"] = p["qkv"].to(torch.bfloat16)
    return p


def _calls(p):
    """check name -> (kernel wrapper call, plain call, tensors the kernel
    reads, ops by operand type) on one input set. The packed core runs fp32
    on the fp32 path and is held in bf16 too."""
    from aiic_tpu_torch.ops import attention, mlp, quant

    bsz, seq, width = p["x"].shape
    heads, mlp_dim = p["heads"], p["w1"].shape[-1]
    rows, dim = bsz * seq, width // heads
    core = 4 * bsz * heads * seq * seq * dim  # Q.K^T and p.V
    attn_q = (p["x"], p["ln_s"], p["ln_b"], p["wqkv_q"], p["sqkv"], p["bqkv"], p["wo"], p["bo"],
              p["mask"])
    mlp_q = (p["x"], p["ln_s"], p["ln_b"], p["w1_q"], p["s1"], p["b1"], p["w2_q"], p["s2"],
             p["b2"])
    attn_b = (p["x"], p["ln_s"], p["ln_b"], p["wqkv_b"], p["bqkv"], p["wo"], p["bo"], p["mask"])
    mlp_b = (p["x"], p["ln_s"], p["ln_b"], p["w1_b"], p["b1"], p["w2_b"], p["b2"])
    h = dict(heads=heads)
    return {
        "int8_ln_qkv_attention": (
            lambda: quant.int8_ln_qkv_attention(*attn_q, **h),
            lambda: quant.int8_ln_qkv_attention_ref(*attn_q, **h), attn_q,
            {"int8": 2 * rows * width * 3 * width, "bf16": core + 2 * rows * width * width}),
        "int8_ln_mlp": (
            lambda: quant.int8_ln_mlp(*mlp_q), lambda: quant.int8_ln_mlp_ref(*mlp_q), mlp_q,
            {"int8": 4 * rows * width * mlp_dim}),
        "fused_ln_qkv_attention": (
            lambda: attention.fused_ln_qkv_attention(*attn_b, **h),
            lambda: attention.fused_ln_qkv_attention_ref(*attn_b, **h), attn_b,
            {"bf16": 2 * rows * width * 4 * width + core}),
        "fused_attention_qkv": (
            lambda: attention.fused_attention_qkv(p["qkv"], p["mask"], **h),
            lambda: attention.fused_attention_qkv_ref(p["qkv"], p["mask"], heads),
            (p["qkv"], p["mask"]), {"fp32": core}),
        "fused_attention_qkv_bf16": (
            lambda: attention.fused_attention_qkv(p["qkv_b"], p["mask"], **h),
            lambda: attention.fused_attention_qkv_ref(p["qkv_b"], p["mask"], heads),
            (p["qkv_b"], p["mask"]), {"bf16": core}),
        "fused_ln_mlp": (
            lambda: mlp.fused_ln_mlp(*mlp_b), lambda: mlp.fused_ln_mlp_ref(*mlp_b), mlp_b,
            {"bf16": 4 * rows * width * mlp_dim}),
    }


def _bound(inputs, out, ops) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, the output written once) over HBM bandwidth and
    the operations over the peak rate of their operand type."""
    import torch

    nbytes = sum(t.nbytes for t in inputs if isinstance(t, torch.Tensor)) + out.nbytes
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = sum(n / PEAK_OPS[kind] for kind, n in ops.items()) * 1e3
    return {"bound_ms": max(mem_ms, ops_ms), "bound_by": "operations" if ops_ms >= mem_ms else "bytes",
            "bytes": nbytes, "ops": ops}


def _ulp(v):
    import torch

    return torch.exp2(torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -126))) - 7)


def _agreement(out, ref, row_scale: bool = False) -> dict:
    """Agreement with the plain version and whether it passes: the bf16 bar
    for bf16 outputs (per row for the text-block kernels, ``row_scale``),
    the fp32 bar for fp32 ones."""
    import torch

    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    err = (o - r).abs()
    cos = torch.nn.functional.cosine_similarity(o, r, dim=-1)
    row_ulp = _ulp(r.abs().amax(dim=-1, keepdim=True))
    a = {
        "dtype": str(out.dtype).replace("torch.", ""),
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / r.abs().clamp(min=1.0)).max()),
        "within_2ulp": float((err <= 2 * _ulp(r)).float().mean()),
        "max_err_in_row_max_ulps": float((err / row_ulp).max()),
        "min_row_cos": float(cos.min()),
        "finite": bool(torch.isfinite(o).all()),
    }
    if out.dtype == torch.float32:
        a["ok"] = a["finite"] and a["max_rel_err"] <= F32_REL
    elif row_scale:
        a["ok"] = (a["finite"] and a["min_row_cos"] >= COS_MIN
                   and a["max_err_in_row_max_ulps"] <= 2)
    else:
        a["ok"] = a["finite"] and a["min_row_cos"] >= COS_MIN and a["within_2ulp"] >= ULP_SHARE
    return a


def phase_kernels(device) -> dict:
    import torch

    cases = [
        ("image B=8", dict(bsz=8, seq=197, width=768, heads=12, mask=False, zero_row=False)),
        ("text B=48 causal", dict(bsz=48, seq=77, width=512, heads=8, mask=True, zero_row=False)),
        ("image B=1", dict(bsz=1, seq=197, width=768, heads=12, mask=False, zero_row=False)),
        ("image B=3", dict(bsz=3, seq=197, width=768, heads=12, mask=False, zero_row=False)),
        ("image B=2 zero row", dict(bsz=2, seq=197, width=768, heads=12, mask=False, zero_row=True)),
    ]
    rng = np.random.default_rng(0)
    worst = {}
    results = []
    for label, kw in cases:
        p = _half_block_inputs(rng, device=device, **kw)
        for name, (kernel, plain, _, _) in _calls(p).items():
            out = kernel()
            torch.cuda.synchronize()
            ref = plain()
            a = _agreement(out, ref)
            a.update(kernel=name, case=label)
            results.append(a)
            log(f"[kernels] {name:24s} {label:20s} {a['dtype']:8s} max_abs_err={a['max_abs_err']:.6g} "
                f"max_rel_err={a['max_rel_err']:.3g} within_2ulp={a['within_2ulp']:.6f} "
                f"min_row_cos={a['min_row_cos']:.8f}")
            if not a["ok"]:
                raise AssertionError(f"{name} disagrees with its plain version on {label}: {a}")
            worst[name] = max(worst.get(name, 0.0), a["max_abs_err"])
    REPORT["kernel_checks"] = results
    return worst


# ---------------------------------------------------------------------------
# Phases 4-5: the slice, and the CPU comparison
# ---------------------------------------------------------------------------


def _pixels(rng, n, size):
    return rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _engine(params, device, opts, **kw):
    import torch

    from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer
    from aiic_tpu_torch.models.config import VIT_B_16

    opts = dict(opts, dtype=getattr(torch, opts["dtype"]))
    return InteriorAnalyzer(params, VIT_B_16, training_data=TRAINING_DATA, device=device,
                            **opts, **kw)


def phase_path(label: str, params, device, requests, tag: str = "", **engine_kw):
    """One path: every count set to 0, the engine built (text features
    through the text tower) and asked three requests; then every kernel's
    launches must be exactly what the path runs (12 text layers at build,
    11 image layers per chunk: the last image block is the CLS-row block)
    and 0 for the others. ``engine_kw`` (``use_lora`` ...) go to the engine
    of ``PATHS[label]``, reported as ``label + tag``."""
    import torch

    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.ops._build import launch_counts, reset_launch_counts

    opts, kernels = PATHS[label]
    reset_launch_counts()
    t0 = time.perf_counter()
    engine = _engine(params, device, opts, **engine_kw)
    label = label + tag
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    at_build = launch_counts()
    # the 7-image request unfiltered, so the attribute branch runs too
    answers = [engine.analyze_pixels(px, filter_interiors=len(px) != 7) for px in requests]
    torch.cuda.synchronize()
    launches = launch_counts()

    want_build = VIT_B_16.text.layers  # one text batch of all prompts
    chunks = sum(-(-len(px) // engine.max_batch) for px in requests)
    want = want_build + (VIT_B_16.vision.layers - 1) * chunks
    log(f"[path {label}] {opts}: engine built in {build_s:.3f} s; launches at build "
        f"{at_build}, after requests {launches} (expected {want_build} and {want} for "
        f"{list(kernels)}, 0 for the others)")
    for name in launches:
        exp_build, exp = (want_build, want) if name in kernels else (0, 0)
        if at_build[name] != exp_build or launches[name] != exp:
            raise AssertionError(f"path {label}: {name} launched {at_build[name]} times at build "
                                 f"and {launches[name]} in all, expected {exp_build} and {exp}")
    for px, res in zip(requests, answers):
        if len(res) != len(px):
            raise AssertionError(f"{len(res)} answers for {len(px)} images")
        for r in res:
            if set(r) != {"is_interior", "interior_confidence", "detected_category",
                          "analysis", "reason"} or not np.isfinite(r["interior_confidence"]):
                raise AssertionError(f"malformed answer {r}")
    raw = engine.classify_pixels(requests[2])
    for k, v in raw.items():
        if v.dtype.kind == "f" and not np.isfinite(v).all():
            raise AssertionError(f"non-finite {k}")
    if raw["features"].shape != (64, VIT_B_16.embed_dim):
        raise AssertionError(f"features shape {raw['features'].shape}")
    if not all(r["is_interior"] and len(r["analysis"]) == len(engine.category_names)
               for r in answers[1]):
        raise AssertionError("an unfiltered answer lacks its attribute analysis")
    verdicts = [r["is_interior"] for res in answers[::2] for r in res]
    log(f"[path {label}] answered {[len(px) for px in requests]} images; {sum(verdicts)} of "
        f"{len(verdicts)} filtered ones judged interior; all outputs finite")
    REPORT.setdefault("paths", {})[label] = {
        "options": opts, "build_s": build_s, "launches_at_build": at_build,
        "launches": launches, "expected": want}
    return engine, {name: launches[name] for name in kernels}


def phase_slice(device):
    """Phase 4: the four paths from one seeded init."""
    import torch

    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.models.init import init_clip_params

    gen = torch.Generator(device=device).manual_seed(0)
    params = init_clip_params(VIT_B_16, gen, device=device)
    rng = np.random.default_rng(1)
    requests = [_pixels(rng, n, VIT_B_16.image_size) for n in (1, 7, 64)]
    engines, launches = {}, {}
    for label in PATHS:
        engine, counts = phase_path(label, params, device, requests)
        launches.update(counts)
        if label in ("int8", "bf16"):  # compared with the CPU and timed below
            engines[label] = engine
    return engines, params, launches


def phase_cpu_compare(label: str, engine, params, tag: str = "", **engine_kw) -> None:
    """Phase 5: the same weights and pixels through the engine's plain
    versions on the CPU."""
    import torch

    from aiic_tpu_torch.models.init import tree_map

    cpu_params = tree_map(lambda t: t.cpu(), params)
    t0 = time.perf_counter()
    cpu = _engine(cpu_params, "cpu", PATHS[label][0], **engine_kw)
    label = label + tag
    px = _pixels(np.random.default_rng(2), 4, engine.config.image_size)
    a = engine.classify_pixels(px)
    b = cpu.classify_pixels(px)
    fa, fb = a["features"], b["features"]
    cos = (fa * fb).sum(-1) / (np.linalg.norm(fa, axis=-1) * np.linalg.norm(fb, axis=-1))
    text_cos = float(torch.nn.functional.cosine_similarity(
        engine.det_text.float().cpu(), cpu.det_text.float(), dim=-1).min())
    verdict = lambda r: (r["interior_mass"] > r["non_interior_mass"]) & (r["top_conf"] > 0.3)  # noqa: E731
    same_verdict = bool((verdict(a) == verdict(b)).all())
    same_top1 = bool((a["top_idx"] == b["top_idx"]).all())
    log(f"[cpu {label}] plain CPU path vs card on 4 images ({time.perf_counter() - t0:.1f} s): "
        f"min feature cosine {cos.min():.6f}, min detector-text cosine {text_cos:.6f}, "
        f"verdicts equal {same_verdict}, top-1 equal {same_top1}; "
        f"top_conf card {np.round(a['top_conf'], 5).tolist()} cpu {np.round(b['top_conf'], 5).tolist()}")
    res = {"min_feature_cos": float(cos.min()), "min_text_cos": text_cos,
           "same_verdict": same_verdict, "same_top1": same_top1}
    REPORT.setdefault("cpu_compare", {})[label] = res
    if min(cos.min(), text_cos) < 0.999 or not same_verdict or not same_top1:
        raise AssertionError(f"card and CPU disagree on the {label} path: {res}")


def _rank4_checkpoint(path: str) -> None:
    """A seeded rank-4 c_fc/c_proj text adapter with nonzero B, in the
    reference ``.pth`` layout (the shape of the reference's shipped ones)."""
    import torch

    from aiic_tpu_torch.adapters import save_lora_pth
    from aiic_tpu_torch.models.config import VIT_B_16

    t = VIT_B_16.text
    rng = np.random.default_rng(13)
    def f(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.02).astype(np.float32))

    save_lora_pth({"c_fc": {"A": f(t.layers, t.width, 4), "B": f(t.layers, 4, t.mlp_dim)},
                   "c_proj": {"A": f(t.layers, t.mlp_dim, 4), "B": f(t.layers, 4, t.width)}},
                  path)


def phase_lora_engines(params, device, base, root: str) -> None:
    """Int8 ``use_lora`` engines from the ``int8_text`` adapters of phase 7
    (rank 16, alpha 32; the analyzer folds only c_fc and c_proj, so the
    checkpoint's out_proj factors are skipped, as in the JAX engine) and from
    a rank-4 checkpoint with the analyzer's default rank and alpha: each
    answers 1, 7 and 64 images with exact launch counts, its text features
    differ from those of ``base`` (the same backbone without the adapter),
    and it agrees with its CPU run."""
    from aiic_tpu_torch.models.config import VIT_B_16

    rng = np.random.default_rng(12)
    requests = [_pixels(rng, n, VIT_B_16.image_size) for n in (1, 7, 64)]
    rank4 = os.path.join(root, "rank4.pth")
    _rank4_checkpoint(rank4)
    cases = {
        "_lora_int8_text": dict(lora_weights_path=os.path.join(root, "int8_text", "adapters.pth"),
                                lora_rank=16, lora_alpha=32),
        "_lora_rank4": dict(lora_weights_path=rank4),
    }
    for tag, kw in cases.items():
        engine, _ = phase_path("int8", params, device, requests, tag=tag, use_lora=True, **kw)
        moved = float((engine.det_text - base.det_text).abs().max())
        log(f"[path int8{tag}] max |text feature change| from the adapter: {moved:.6g}")
        REPORT["paths"]["int8" + tag]["text_feature_change"] = moved
        if not moved > 0:
            raise AssertionError(f"use_lora {tag}: the adapter left the text features unchanged")
        phase_cpu_compare("int8", engine, params, tag=tag, use_lora=True, **kw)
        del engine


# ---------------------------------------------------------------------------
# Phases 6-8: training
# ---------------------------------------------------------------------------

# The training paths of phase 7: TrainConfig options, the resolved text path.
TRAIN_PATHS = {
    "fp32_auto": (dict(dtype="float32", attn_impl="auto"), "pallas_vjp"),
    "fp32_block_fused": (dict(dtype="float32", attn_impl="block_fused"), "block_fused"),
    "bf16_block_fused": (dict(dtype="bfloat16", attn_impl="block_fused"), "block_fused"),
    # train_lora --attn-impl block_fused --quantize-text --quantize-image
    "int8_text": (dict(dtype="float32", attn_impl="block_fused", quantize_text=True,
                       quantize_image=True), "block_fused_int8"),
}
TRAIN_ITEMS, TRAIN_BATCH, TRAIN_EPOCHS = 56, 16, 2
STYLES = ["nowoczesny", "klasyczny", "skandynawski", "industrialny"]
ROOMS = ["kuchnia", "salon", "sypialnia", ""]
CHARS = ["czyste linie", "przestronne", "eleganckie", "jasne"]
# The LoRA cotangents are fp32 sums over all B*S rows: in fp32 a kernel
# agrees when max |kernel - plain| <= LORA_F32_REL * max |plain| per factor;
# in bf16 when the factor's cosine to the plain one is at least COS_MIN.
LORA_F32_REL = 1e-5


def _text_block_inputs(rng, bsz, dtype, device, rank=16, w=512):
    """The B/16 text block (S=77, W=512, M=2048, H=8; or another width w,
    M = 4w) with rank-16 LoRA on all three attach points, B nonzero; x and an
    output cotangent."""
    import torch

    from aiic_tpu_torch.models.clip import causal_mask

    m = 4 * w

    def t(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(device)

    bp = {"ln1": {"scale": 1 + t(w, std=0.1), "bias": t(w, std=0.1)},
          "ln2": {"scale": 1 + t(w, std=0.1), "bias": t(w, std=0.1)},
          "attn": {"wqkv": t(w, 3 * w, std=w ** -0.5), "bqkv": t(3 * w, std=0.1),
                   "wo": t(w, w, std=w ** -0.5), "bo": t(w, std=0.1)},
          "mlp": {"w1": t(w, m, std=w ** -0.5), "b1": t(m, std=0.1),
                  "w2": t(m, w, std=m ** -0.5), "b2": t(w, std=0.1)}}
    dims = {"out_proj": (w, w), "c_fc": (w, m), "c_proj": (m, w)}
    lora = {p: {"A": t(dims[p][0], rank, std=0.02), "B": t(rank, dims[p][1], std=0.02)}
            for p in dims}
    return {"x": t(bsz, 77, w).to(dtype), "dy": t(bsz, 77, w, std=0.01).to(dtype),
            "mask": causal_mask(77, device=device), "bp": bp, "lora": lora, "heads": w // 64}


def _quantized(bp):
    """The per-output-channel int8 weights of one block, as
    ``quantize_model_mlp`` makes them: {wqkv_q, sqkv, w1_q, s1, w2_q, s2}."""
    from aiic_tpu_torch.ops.quant import quantize_weight

    qw = {}
    for key, scale, (grp, name) in (("wqkv_q", "sqkv", ("attn", "wqkv")),
                                    ("w1_q", "s1", ("mlp", "w1")), ("w2_q", "s2", ("mlp", "w2"))):
        qw[key], qw[scale] = quantize_weight(bp[grp][name])
    return qw


def _tree_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_tensors(v)]
    return [tree]


def _block_calls(p):
    """name -> (kernel call, plain call, tensors the kernel reads, ops by
    type). The operations are what the function does on these inputs. The
    forward: the backbone products 2 rows W (4W + 2M), the core 4 B H S^2 D,
    the rank-r products 2 rows (r_o 2W + r_f (W + M) + r_p (M + W)). The
    backward recomputes the forward without its last product (y itself is
    not needed): 2 rows W (4W + M), the core, the rank-r products less u_ap
    Bp; then the four input-gradient products 2 rows W (4W + 2M), the core's
    8 B H S^2 D, and the rank-r cotangent and gradient products 2 rows
    (4 r_o W + 2 r_f (W + M) + 2 r_p (W + M)). (The TPU cost estimate,
    block_grad.py:958-964, counts three full forwards: 381.3 GFLOP at B=256
    against the 216.0 + rank-r counted here.)"""
    from aiic_tpu_torch.ops import block_grad

    x, dy, mask, bp, lora = p["x"], p["dy"], p["mask"], p["bp"], p["lora"]
    ops = _block_ops(p)
    fwd, bwd = (sum(o.values()) for o in ops)
    kind = "fp32" if x.dtype.itemsize == 4 else "bf16"
    kw = dict(heads=p["heads"], scaling=2.0)
    weights = _tree_tensors(bp) + _tree_tensors(lora)
    return {
        "text_block_fwd": (
            lambda: block_grad.text_block_fwd(x, mask, bp, lora, **kw),
            lambda: block_grad.text_block_fwd_ref(x, mask, bp, lora, **kw),
            [x, mask, *weights], {kind: fwd}),
        "text_block_bwd": (
            lambda: block_grad.text_block_bwd(x, dy, mask, bp, lora, **kw),
            lambda: block_grad.text_block_bwd_ref(x, dy, mask, bp, lora, **kw),
            [x, dy, mask, *weights], {kind: bwd}),
    }


def _block_ops(p):
    """(forward, backward) operations of one text block by product:
    {"wide": the backbone products (QKV, c_fc, c_proj), "wo": the output
    projection, "rest": the core and the rank-r products}."""
    x, bp, lora = p["x"], p["bp"], p["lora"]
    bsz, seq, w = x.shape
    rows, heads, m = bsz * seq, p["heads"], bp["mlp"]["w1"].shape[-1]
    r_o, r_f, r_p = (lora[k]["A"].shape[-1] for k in ("out_proj", "c_fc", "c_proj"))
    core = 4 * bsz * heads * seq * seq * (w // heads)
    fwd_rank = 2 * rows * (r_o * 2 * w + r_f * (w + m) + r_p * (m + w))
    fwd = {"wide": 2 * rows * w * (3 * w + 2 * m), "wo": 2 * rows * w * w,
           "rest": core + fwd_rank}
    bwd = {"wide": 2 * rows * w * (3 * w + m) + 2 * rows * w * (3 * w + 2 * m),
           "wo": 2 * 2 * rows * w * w,
           "rest": (core + fwd_rank - 2 * rows * r_p * w + 2 * core
                    + 2 * rows * (4 * r_o * w + 2 * r_f * (w + m) + 2 * r_p * (w + m)))}
    return fwd, bwd


def _int8_block_calls(p):
    """As ``_block_calls`` for the int8 pair on the weights of ``p``,
    quantized per output channel: the wide products count at the int8 peak,
    wo, the core and the rank-r products at the bf16 one. The plain version
    takes the plan's chunk count, which the wrappers resolve themselves."""
    from aiic_tpu_torch.ops import block_grad

    x, dy, mask, bp, lora = p["x"], p["dy"], p["mask"], p["bp"], p["lora"]
    qw = p["qw"]
    bsz, seq, width = x.shape
    n_chunks = block_grad.text_block_int8_plan(seq, width, 4 * width, p["heads"], bsz=bsz)[1]
    kw = dict(heads=p["heads"], scaling=2.0)
    ops = [{"int8": o["wide"], "bf16": o["wo"] + o["rest"]} for o in _block_ops(p)]
    weights = _tree_tensors(bp) + _tree_tensors(lora) + list(qw.values())
    return {
        "text_block_fwd_int8": (
            lambda: block_grad.text_block_fwd_int8(x, mask, bp, qw, lora, **kw),
            lambda: block_grad.text_block_fwd_int8_ref(x, mask, bp, qw, lora, n_chunks=n_chunks,
                                                       **kw),
            [x, mask, *weights], ops[0]),
        "text_block_bwd_int8": (
            lambda: block_grad.text_block_bwd_int8(x, dy, mask, bp, qw, lora, **kw),
            lambda: block_grad.text_block_bwd_int8_ref(x, dy, mask, bp, qw, lora,
                                                       n_chunks=n_chunks, **kw),
            [x, dy, mask, *weights], ops[1]),
    }


def _lora_agreement(got: dict, ref: dict, fp32: bool) -> dict:
    import torch

    worst = {}
    for pt in ref:
        for ab in "AB":
            g, r = got[pt][ab], ref[pt][ab]
            worst[f"{pt}.{ab}"] = (
                float((g - r).abs().max() / r.abs().max()) if fp32 else
                float(torch.nn.functional.cosine_similarity(g.flatten(), r.flatten(), dim=0)))
    ok = (all(v <= LORA_F32_REL for v in worst.values()) if fp32
          else all(v >= COS_MIN for v in worst.values()))
    return {"per_factor": worst, "ok": ok}


def phase_text_block_kernels(device) -> dict:
    """Phase 6: the text-block kernels against their plain versions."""
    import torch

    rng = np.random.default_rng(5)
    worst, results = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        for bsz in (1, 7, 64):
            p = _text_block_inputs(rng, bsz, dtype, device)
            calls = _block_calls(p)
            y = calls["text_block_fwd"][0]()
            dx, dl = calls["text_block_bwd"][0]()
            torch.cuda.synchronize()
            y_ref = calls["text_block_fwd"][1]()
            dx_ref, dl_ref = calls["text_block_bwd"][1]()
            label = f"B={bsz} S=77 W=512"
            for name, out, ref in (("text_block_fwd", y, y_ref), ("text_block_bwd", dx, dx_ref)):
                a = _agreement(out, ref, row_scale=True)
                a.update(kernel=name, case=label)
                if name == "text_block_bwd":
                    a["lora"] = _lora_agreement(dl, dl_ref, dtype == torch.float32)
                    a["ok"] = a["ok"] and a["lora"]["ok"]
                results.append(a)
                log(f"[kernels] {name:24s} {label:20s} {a['dtype']:8s} "
                    f"max_abs_err={a['max_abs_err']:.6g} max_rel_err={a['max_rel_err']:.3g} "
                    f"within_2ulp={a['within_2ulp']:.6f} "
                    f"max_err_in_row_max_ulps={a['max_err_in_row_max_ulps']:.3g} "
                    f"min_row_cos={a['min_row_cos']:.8f}"
                    + (f" lora={a['lora']['per_factor']}" if "lora" in a else ""))
                if not a["ok"]:
                    raise AssertionError(f"{name} disagrees with its plain version on {label}: {a}")
                if dtype == torch.float32:  # the line reports the fp32 (CLI default) kernel
                    worst[name] = max(worst.get(name, 0.0), a["max_abs_err"])
    cases = [(f"B={bsz} S=77 W=512", dict(bsz=bsz)) for bsz in (1, 7, 64)]
    cases.append(("B=7 S=77 W=768 chunked", dict(bsz=7, w=768)))
    for label, kw in cases:
        p = _text_block_inputs(rng, dtype=torch.bfloat16, device=device, **kw)
        p["qw"] = _quantized(p["bp"])
        calls = _int8_block_calls(p)
        y = calls["text_block_fwd_int8"][0]()
        dx, dl = calls["text_block_bwd_int8"][0]()
        torch.cuda.synchronize()
        y_ref = calls["text_block_fwd_int8"][1]()
        dx_ref, dl_ref = calls["text_block_bwd_int8"][1]()
        for name, out, ref in (("text_block_fwd_int8", y, y_ref),
                               ("text_block_bwd_int8", dx, dx_ref)):
            a = _agreement(out, ref, row_scale=True)
            a.update(kernel=name, case=label)
            if name == "text_block_bwd_int8":
                a["lora"] = _lora_agreement(dl, dl_ref, False)
                a["ok"] = (a["finite"] and a["min_row_cos"] >= COS_MIN) and a["lora"]["ok"]
            results.append(a)
            log(f"[kernels] {name:24s} {label:24s} {a['dtype']:8s} "
                f"max_abs_err={a['max_abs_err']:.6g} max_rel_err={a['max_rel_err']:.3g} "
                f"within_2ulp={a['within_2ulp']:.6f} "
                f"max_err_in_row_max_ulps={a['max_err_in_row_max_ulps']:.3g} "
                f"min_row_cos={a['min_row_cos']:.8f}"
                + (f" lora={a['lora']['per_factor']}" if "lora" in a else ""))
            if not a["ok"]:
                raise AssertionError(f"{name} disagrees with its plain version on {label}: {a}")
            worst[name] = max(worst.get(name, 0.0), a["max_abs_err"])
    REPORT["text_block_checks"] = results
    return worst


def _synth_dataset(root: str, n: int, size: int = 256):
    """n random size x size PNGs and a dataset JSON with items built like
    TRAINING_DATA (style, room type, characteristics, materials, colours)."""
    from PIL import Image

    rng = np.random.default_rng(7)
    items = []
    for i in range(n):
        name = f"img{i:03d}.png"
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            os.path.join(root, name))
        items.append({"image_path": name, "style": STYLES[i % 4],
                      "characteristics": CHARS[: i % 3], "materials": ["drewno"],
                      "colors": ["biały"], "room_type": ROOMS[(i // 4) % 4]})
    path = os.path.join(root, "dataset.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"training_data": items}, f, ensure_ascii=False)
    return path


def _train_config(opts, **kw):
    import torch

    from aiic_tpu_torch.train import TrainConfig

    return TrainConfig(**dict(opts, dtype=getattr(torch, opts["dtype"])), **kw)


def _path_params(params, opts):
    """The backbone as ``train_lora`` hands it to the step: with
    ``quantize_text``, the text tower's int8 weights attached."""
    from aiic_tpu_torch.ops.quant import quantize_model_mlp

    return (quantize_model_mlp(params, attn=True, towers=("text",))
            if opts.get("quantize_text") else params)


def _expected_train_launches(opts: dict, text_impl: str, n_items: int) -> dict:
    """Launches of one train_lora run, derived from the design:

    - the image-feature precompute runs the frozen tower once per chunk of
      TRAIN_BATCH unique images (the last padded): 11 launches per chunk of
      the packed core (fp32), of the bf16 attention half-block, or (with
      ``quantize_image``) of each int8 half-block (the last image block is
      the CLS-row block, no kernel);
    - pallas_vjp (remat on): the packed core 12 times per text encode, and
      12 more per train step where the backward recomputes each block: 24
      per train step, 12 per eval step;
    - block_fused: ``text_block_fwd`` 12 per train and per eval step,
      ``text_block_bwd`` 12 per train step (no remat: the backward kernel
      recomputes its forward itself); block_fused_int8 the same of
      ``text_block_fwd_int8`` and ``text_block_bwd_int8``."""
    n_val = max(1, int(n_items * 0.1))
    train_steps = TRAIN_EPOCHS * ((n_items - n_val) // TRAIN_BATCH)
    eval_steps = TRAIN_EPOCHS * max(1, n_val // TRAIN_BATCH)
    chunks = -(-n_items // TRAIN_BATCH)
    if opts.get("quantize_image"):
        image = ("int8_ln_qkv_attention", "int8_ln_mlp")
    else:
        image = ("fused_attention_qkv" if opts["dtype"] == "float32" else "fused_ln_qkv_attention",)
    want = {name: 11 * chunks for name in image}
    if text_impl == "pallas_vjp":
        want["fused_attention_qkv"] = want.get("fused_attention_qkv", 0) + 24 * train_steps \
            + 12 * eval_steps
    else:
        suffix = "_int8" if text_impl == "block_fused_int8" else ""
        want["text_block_fwd" + suffix] = 12 * (train_steps + eval_steps)
        want["text_block_bwd" + suffix] = 12 * train_steps
    return want


def phase_train(params, device, root: str) -> dict:
    """Phase 7: train_lora on each path from the serving phases' seeded
    init, with exact launch counts; the adapters go under ``root``."""
    import torch

    from aiic_tpu_torch.adapters import parse_lora_key
    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.ops._build import launch_counts, reset_launch_counts
    from aiic_tpu_torch.train import train_lora

    launches, rates = {}, {}
    t0 = time.perf_counter()
    json_path = _synth_dataset(root, TRAIN_ITEMS)
    log(f"[train] synthetic dataset of {TRAIN_ITEMS} 256x256 PNGs written in "
        f"{time.perf_counter() - t0:.2f} s")
    for label, (opts, text_impl) in TRAIN_PATHS.items():
        save = os.path.join(root, label, "adapters.pth")
        cfg = _train_config(opts, epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH, seed=0)
        reset_launch_counts()
        t0 = time.perf_counter()
        out = train_lora(json_path, save, params=params, config=VIT_B_16, cfg=cfg,
                         log=lambda msg, label=label: log(f"[train {label}] {msg}"),
                         device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = launch_counts()
        want = _expected_train_launches(opts, text_impl, TRAIN_ITEMS)
        log(f"[train {label}] {opts}: {seconds:.2f} s; launches {got} (expected {want}, "
            f"0 for the others)")
        for name, n in got.items():
            if n != want.get(name, 0):
                raise AssertionError(f"train {label}: {name} launched {n} times, "
                                     f"expected {want.get(name, 0)}")
        hist = out["history"]
        if not all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"]) for h in hist):
            raise AssertionError(f"train {label}: non-finite loss {hist}")
        moved = max(float(out["lora_tree"][p]["B"].abs().max()) for p in out["lora_tree"])
        if not moved > 0:
            raise AssertionError(f"train {label}: adapter B did not move off zero")
        sd = torch.load(save, map_location="cpu", weights_only=True)
        if (len(sd) != 6 * VIT_B_16.text.layers
                or not all(parse_lora_key(k) and k.startswith("clip_model.") for k in sd)
                or not all(v.dtype == torch.float32 for v in sd.values())):
            raise AssertionError(f"train {label}: .pth keys {sorted(sd)[:3]}...")
        last = hist[-1]
        rates[label] = last["train_images"] / last["train_seconds"]
        log(f"[train {label}] losses {[(h['train_loss'], h['val_loss']) for h in hist]}; "
            f"max |B| {moved:.3g}; .pth has {len(sd)} reference keys; epoch "
            f"{last['epoch']}: {last['train_images']} images in "
            f"{last['train_seconds']:.3f} s = {rates[label]:.1f} images/s")
        REPORT.setdefault("train", {})[label] = {
            "options": opts, "text_impl": text_impl, "seconds": seconds, "history": hist,
            "launches": got, "expected": want, "epoch_images_per_s": rates[label]}
        for name in ("text_block_fwd", "text_block_bwd", "text_block_fwd_int8",
                     "text_block_bwd_int8"):
            launches[name] = launches.get(name, 0) + got[name]
    return launches, rates


def _step_batch(rng, rows: int, device):
    """Cached-feature rows and dense token rows of distinct prompts."""
    import torch

    from aiic_tpu_torch.data.tokenizer import tokenize_for_model
    from aiic_tpu_torch.models.config import VIT_B_16

    feats = rng.standard_normal((rows, VIT_B_16.embed_dim)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    prompts = [f"{CHARS[i % 4]} {STYLES[(i // 4) % 4]} wnętrze {ROOMS[(i // 16) % 4]} {i}"
               for i in range(rows)]
    tokens = tokenize_for_model(prompts, VIT_B_16)
    return torch.from_numpy(feats).to(device), torch.from_numpy(tokens).to(device)


def _lora_init(rng, device):
    import torch

    from aiic_tpu_torch.models.config import VIT_B_16

    t = VIT_B_16.text
    dims = {"out_proj": (t.width, t.width), "c_fc": (t.width, t.mlp_dim),
            "c_proj": (t.mlp_dim, t.width)}
    return {p: {ab: torch.from_numpy((rng.standard_normal(
        (t.layers, *((dims[p][0], 16) if ab == "A" else (16, dims[p][1])))) * 0.02)
        .astype(np.float32)).to(device) for ab in "AB"} for p in dims}


def _one_step(params, lora, feats, tokens, opts, impl, device):
    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.train import make_optimizer, make_train_step

    cfg = _train_config(dict(opts, attn_impl=impl), epochs=2, batch_size=len(feats))
    opt = make_optimizer(cfg, steps_per_epoch=1)
    step, _ = make_train_step(VIT_B_16, cfg, opt, cached_image=True, device=device)
    loss, new, state = step(params, lora, opt.init(lora), feats, tokens)
    return float(loss), new, state, cfg.lr


# The int8 text path's card step agrees with its CPU step to a gradient
# cosine of 0.9978-0.9984 (NVIDIA H100, the first run of this check), not the
# 0.999 of bf16: the two run the same quantization sites, but their fp32 LN,
# core and bf16-product sums differ in order, so here and there an activation
# rounds to the neighbouring int8 value, and a flipped int8 quantum (1/127 of
# its row's largest value, against a bf16 ULP's 1/256 of the value itself)
# moves a whole output row of its product; over 12 layers of the
# straight-through backward at 8 rows that costs ~2e-3 of cosine. The bar is
# set at 0.995 for that path; its loss keeps the bf16 bar.
INT8_STEP_GRAD_COS = 0.995


def _step_agreement(a, b, fp32: bool, grad_cos: float = 0.999) -> dict:
    """Card step a against step b: loss, first Adam moment (0.1 x the
    gradient), updated adapters. fp32: loss rel <= 1e-5, moment within 1e-4
    of its largest entry, adapters within 1e-6 where the gradient is above
    1e-3 of its largest entry and within 4 lr elsewhere (an Adam step moves
    each element by about lr whatever its gradient's size). bf16 and the
    int8 text path: loss rel <= 2e-3, moment cosine >= ``grad_cos``,
    adapters within 4 lr."""
    import torch

    loss_rel = abs(a[0] - b[0]) / abs(b[0])
    res = {"loss": a[0], "loss_ref": b[0], "loss_rel": loss_rel, "moment": {}, "adapters": {}}
    ok = loss_rel <= (1e-5 if fp32 else 2e-3)
    lr = a[3]
    for pt in b[1]:
        for ab in "AB":
            m, mr = a[2]["exp_avg"][pt][ab].cpu(), b[2]["exp_avg"][pt][ab].cpu()
            new, newr = a[1][pt][ab].cpu(), b[1][pt][ab].cpu()
            diff = (new - newr).abs()
            if fp32:
                res["moment"][f"{pt}.{ab}"] = mv = float((m - mr).abs().max() / mr.abs().max())
                clear = mr.abs() > 1e-3 * mr.abs().max()
                res["adapters"][f"{pt}.{ab}"] = av = float(diff[clear].max())
                ok = ok and mv <= 1e-4 and av <= 1e-6 and float(diff.max()) <= 4 * lr
            else:
                res["moment"][f"{pt}.{ab}"] = mv = float(
                    torch.nn.functional.cosine_similarity(m.flatten(), mr.flatten(), dim=0))
                res["adapters"][f"{pt}.{ab}"] = av = float(diff.max())
                ok = ok and mv >= grad_cos and av <= 4 * lr
    res["ok"] = ok
    return res


def phase_train_compare(params, device) -> None:
    """Phase 8: one text-only train step (8 cached-feature rows, dense token
    rows, the same adapters) on the card against the CPU plain path for each
    training path, and block_fused against xla on the card. The int8 text
    path's weights are quantized once, on the card, and copied."""
    from aiic_tpu_torch.models.init import tree_map
    from aiic_tpu_torch.ops import _build

    saved = _build.launch_counts()
    rng = np.random.default_rng(9)
    feats, tokens = _step_batch(rng, 8, device)
    lora = _lora_init(rng, device)
    cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)  # noqa: E731
    for label, (opts, impl) in TRAIN_PATHS.items():
        t0 = time.perf_counter()
        path_params = _path_params(params, opts)
        # block_fused_int8 is reached from block_fused, which also turns remat off
        impl = opts["attn_impl"] if opts.get("quantize_text") else impl
        card = _one_step(path_params, lora, feats, tokens, opts, impl, device)
        plain = _one_step(cpu(path_params), cpu(lora), feats.cpu(), tokens.cpu(), opts, impl,
                          "cpu")
        quantized = opts.get("quantize_text", False)
        res = _step_agreement(card, plain, opts["dtype"] == "float32" and not quantized,
                              INT8_STEP_GRAD_COS if quantized else 0.999)
        log(f"[train-cpu {label}] one step card vs CPU plain ({time.perf_counter() - t0:.1f} s): "
            f"loss {res['loss']:.7f} vs {res['loss_ref']:.7f} (rel {res['loss_rel']:.3g}); "
            f"moment {res['moment']}; adapters {res['adapters']}")
        REPORT.setdefault("train_cpu_compare", {})[label] = res
        if not res["ok"]:
            raise AssertionError(f"card and CPU disagree on the {label} train step: {res}")
    opts = TRAIN_PATHS["fp32_block_fused"][0]
    block = _one_step(params, lora, feats, tokens, opts, "block_fused", device)
    xla = _one_step(params, lora, feats, tokens, opts, "xla", device)
    res = _step_agreement(block, xla, True)
    log(f"[train-xla] block_fused vs xla on the card, fp32: loss {res['loss']:.7f} vs "
        f"{res['loss_ref']:.7f} (rel {res['loss_rel']:.3g}); moment {res['moment']}")
    REPORT["train_block_vs_xla"] = res
    if not res["ok"]:
        raise AssertionError(f"block_fused and xla disagree on the card: {res}")
    for fn in _build._COUNTED.values():
        fn.launches = saved[fn.__name__]


def train_step_times(params, device, card: str) -> dict:
    """Train-step ms at batch 256 (cached image features, dense text rows,
    so the text kernels see 256 rows) on each training path."""
    import torch

    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.train import make_optimizer, make_train_step

    rng = np.random.default_rng(11)
    feats, tokens = _step_batch(rng, 256, device)
    lora = _lora_init(rng, device)
    times = {}
    for label, (opts, impl) in TRAIN_PATHS.items():
        cfg = _train_config(opts, epochs=2, batch_size=256)
        opt = make_optimizer(cfg, steps_per_epoch=4)
        step, _ = make_train_step(VIT_B_16, cfg, opt, cached_image=True, device=device)
        state, tree = opt.init(lora), lora
        path_params = _path_params(params, opts)
        loss, tree, state = step(path_params, tree, state, feats, tokens)  # warm
        torch.cuda.synchronize()
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            loss, tree, state = step(path_params, tree, state, feats, tokens)
            float(loss)
            ms.append((time.perf_counter() - t0) * 1e3)
        times[f"train_step_{label}"] = r = {"ms": min(ms), "all_ms": ms,
                                            "images_per_s": 256e3 / min(ms)}
        log(f"[timing] train step {label} ({impl}) B=256 dense rows: {r['ms']:.2f} ms "
            f"({r['images_per_s']:.1f} images/s) ({card})")
    return times


# ---------------------------------------------------------------------------
# Phase 9: timings
# ---------------------------------------------------------------------------


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _sdpa_times(p) -> dict:
    """The one PyTorch call that computes the packed core's function:
    ``scaled_dot_product_attention`` on q/k/v as (B, H, S, D), with the
    transposes into and out of that layout timed apart from the call."""
    import torch

    qkv = p["qkv"]
    bsz, seq, w3 = qkv.shape
    heads = p["heads"]
    split = lambda: qkv.view(bsz, seq, 3, heads, w3 // 3 // heads).permute(2, 0, 3, 1, 4).contiguous()  # noqa: E731
    q, k, v = split()
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)  # noqa: E731
    o = sdpa()
    merge = lambda: o.transpose(1, 2).reshape(bsz, seq, w3 // 3)  # noqa: E731
    return {"library_ms": min(_time_ms(sdpa, 10), _time_ms(sdpa, 10)),
            "transpose_ms": _time_ms(split, 10) + _time_ms(merge, 10)}


def _engine_rate(engine, rng) -> dict:
    px = _pixels(rng, 256, engine.config.image_size)
    engine.classify_pixels(px)
    n_rep = 5
    t0 = time.perf_counter()
    for _ in range(n_rep):
        engine.classify_pixels(px)  # returns numpy: synchronised
    ips = n_rep * 256 / (time.perf_counter() - t0)
    one = _pixels(rng, 1, engine.config.image_size)
    engine.classify_pixels(one)
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        engine.classify_pixels(one)
        lat.append((time.perf_counter() - t0) * 1e3)
    return {"images_per_s_b256": ips, "single_image_p50_ms": float(np.percentile(lat, 50))}


def _kernel_times(calls, times, label: str, card: str) -> None:
    """plain, kernel, kernel, plain on one card, for each call."""
    for name, (kernel, plain, inputs, ops) in calls.items():
        t_plain = [_time_ms(plain, 3)]
        t_kernel = [_time_ms(kernel, 10), _time_ms(kernel, 10)]
        t_plain.append(_time_ms(plain, 3))
        out = kernel()
        out = out[0] if isinstance(out, tuple) else out
        times[name] = {"ms": min(t_kernel), "plain_ms": min(t_plain), "library_ms": None,
                       **_bound(inputs, out, ops)}
        t = times[name]
        log(f"[timing] {name:24s} {label}: kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
            f"library {t['library_ms']} ms ({card})")


def phase_timing(device, card: str, engines, params) -> dict:
    """Phase 9. Launches made here are not the paths': the counts are
    saved before and put back after."""
    import torch

    from aiic_tpu_torch.ops import _build

    p = _half_block_inputs(np.random.default_rng(3), 256, 197, 768, 12,
                           mask=False, zero_row=False, device=device)
    times = {}
    saved = _build.launch_counts()
    calls = _calls(p)
    _kernel_times(calls, times, "B=256 S=197 W=768", card)
    for name in ("fused_attention_qkv", "fused_attention_qkv_bf16"):
        times[name].update(_sdpa_times(dict(p, qkv=calls[name][2][0])))
        log(f"[timing] {name:24s} SDPA {times[name]['library_ms']:.3f} ms, transposes "
            f"{times[name]['transpose_ms']:.3f} ms ({card})")
    del p, calls
    rng = np.random.default_rng(6)
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        calls = _block_calls(_text_block_inputs(rng, 256, dtype, device))
        _kernel_times({name + suffix: c for name, c in calls.items()}, times,
                      f"B=256 S=77 W=512 {str(dtype)[6:]}", card)
        del calls
        torch.cuda.empty_cache()
    p = _text_block_inputs(rng, 256, torch.bfloat16, device)
    p["qw"] = _quantized(p["bp"])
    _kernel_times(_int8_block_calls(p), times, "B=256 S=77 W=512 int8", card)
    del p
    torch.cuda.empty_cache()
    times.update(train_step_times(params, device, card))
    for fn in _build._COUNTED.values():
        fn.launches = saved[fn.__name__]
    rng = np.random.default_rng(4)
    for label, engine in engines.items():
        times[f"classify_{label}"] = r = _engine_rate(engine, rng)
        log(f"[timing] classify_pixels {label} B=256: {r['images_per_s_b256']:.1f} images/s; "
            f"single image p50 {r['single_image_p50_ms']:.3f} ms ({card})")
    REPORT["timing"] = times
    return times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this smoke run needs one GPU")
    device = torch.device("cuda", 0)

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    REPORT["card"] = card

    from aiic_tpu_torch.ops._build import BUILD_INFO, load_library

    t0 = time.perf_counter()
    load_library()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {BUILD_INFO['seconds']:.2f} s; by source {BUILD_INFO['per_source_s']}): "
        f"{BUILD_INFO['path']}")
    REPORT["build"] = dict(BUILD_INFO)

    worst = phase_kernels(device)
    worst.update(phase_text_block_kernels(device))
    engines, params, launches = phase_slice(device)
    for label, engine in engines.items():
        phase_cpu_compare(label, engine, params)
    with tempfile.TemporaryDirectory() as root:
        train_launches, epoch_rates = phase_train(params, device, root)
        launches.update(train_launches)
        phase_train_compare(params, device)
        phase_lora_engines(params, device, engines["int8"], root)
    times = phase_timing(device, card, engines, params)
    times["train_lora_epoch_images_per_s"] = epoch_rates
    REPORT["wall_s"] = time.perf_counter() - T0

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{"name": name, "route": "cuda", **meta, "launches": launches[name],
                "max_abs_err": worst[name], **{k: times[name][k] for k in keys}}
               for name, meta in KERNELS.items()]
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(REPORT, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
