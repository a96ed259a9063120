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
6. timings: each kernel against its plain version at B=256 (and the packed
   core against ``scaled_dot_product_attention``), with its bound; classify
   images/s at B=256 and single-image p50 latency of the int8 and the bf16
   unquantized engines.

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
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPORT: dict = {}

# A kernel agrees with its plain version when every row's cosine is at least
# COS_MIN and at least ULP_SHARE of the elements lie within 2 bf16 ULPs of the
# plain value: the two differ only where a summation order moves an fp32
# value across a bf16 or int8 rounding boundary.
# In fp32 a kernel agrees when max |kernel - plain| / max(|plain|, 1) is at
# most F32_REL: only the order of fp32 sums differs.
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


def _agreement(out, ref) -> dict:
    """Agreement with the plain version and whether it passes: the bf16 bar
    for bf16 outputs, the fp32 bar for fp32 ones."""
    import torch

    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    err = (o - r).abs()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp(min=2.0 ** -126))) - 7)
    cos = torch.nn.functional.cosine_similarity(o, r, dim=-1)
    a = {
        "dtype": str(out.dtype).replace("torch.", ""),
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / r.abs().clamp(min=1.0)).max()),
        "within_2ulp": float((err <= 2 * ulp).float().mean()),
        "min_row_cos": float(cos.min()),
        "finite": bool(torch.isfinite(o).all()),
    }
    if out.dtype == torch.float32:
        a["ok"] = a["finite"] and a["max_rel_err"] <= F32_REL
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


def phase_path(label: str, params, device, requests):
    """One path: every count set to 0, the engine built (text features
    through the text tower) and asked three requests; then every kernel's
    launches must be exactly what the path runs (12 text layers at build,
    11 image layers per chunk: the last image block is the CLS-row block)
    and 0 for the others."""
    import torch

    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.ops._build import launch_counts, reset_launch_counts

    opts, kernels = PATHS[label]
    reset_launch_counts()
    t0 = time.perf_counter()
    engine = _engine(params, device, opts)
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


def phase_cpu_compare(label: str, engine, params) -> None:
    """Phase 5: the same weights and pixels through the engine's plain
    versions on the CPU."""
    import torch

    from aiic_tpu_torch.models.init import tree_map

    cpu_params = tree_map(lambda t: t.cpu(), params)
    t0 = time.perf_counter()
    cpu = _engine(cpu_params, "cpu", PATHS[label][0])
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
    if cos.min() < 0.999 or not same_verdict or not same_top1:
        raise AssertionError(f"card and CPU disagree on the {label} path: {res}")


# ---------------------------------------------------------------------------
# Phase 6: timings
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


def phase_timing(device, card: str, engines) -> dict:
    """Phase 6. Launches made here are not the paths': the counts are
    saved before and put back after."""
    from aiic_tpu_torch.ops import _build

    p = _half_block_inputs(np.random.default_rng(3), 256, 197, 768, 12,
                           mask=False, zero_row=False, device=device)
    times = {}
    saved = _build.launch_counts()
    for name, (kernel, plain, inputs, ops) in _calls(p).items():
        # plain, kernel, kernel, plain on one card
        t_plain = [_time_ms(plain, 3)]
        t_kernel = [_time_ms(kernel, 10), _time_ms(kernel, 10)]
        t_plain.append(_time_ms(plain, 3))
        times[name] = {"ms": min(t_kernel), "plain_ms": min(t_plain), "library_ms": None,
                       **_bound(inputs, kernel(), ops)}
        if name.startswith("fused_attention_qkv"):
            times[name].update(_sdpa_times(dict(p, qkv=inputs[0])))
        t = times[name]
        log(f"[timing] {name:24s} B=256 S=197 W=768: kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
            f"library {t['library_ms']} ms ({card})")
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
        f"(nvcc {BUILD_INFO['seconds']:.2f} s): {BUILD_INFO['path']}")
    REPORT["build"] = dict(BUILD_INFO)

    worst = phase_kernels(device)
    engines, params, launches = phase_slice(device)
    for label, engine in engines.items():
        phase_cpu_compare(label, engine, params)
    times = phase_timing(device, card, engines)

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
