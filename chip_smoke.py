#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``aiic_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each of which raises (and so exits non-zero) on failure:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. the Hopper kernels built with nvcc from ``aiic_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, in bf16, at
   the serving path's shapes (ViT-B/16 image and text half-blocks, B=1, an
   odd B, and an all-zero LN row);
4. the slice: a full-width ViT-B/16 int8 ``InteriorAnalyzer`` from a seeded
   init (text features through both kernels at build), answering requests
   of 1, 7 and 64 images; the kernels' launch counters must show the path
   went through them;
5. the same weights and 4 images through the port on the CPU (plain path):
   feature cosine, verdicts and top-1 categories against the card;
6. timings: each kernel against its plain version at B=256, classify
   images/s at B=256, single-image p50 latency.

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
COS_MIN = 0.9999
ULP_SHARE = 0.99

KERNELS = {
    "int8_ln_qkv_attention": {
        "source": "aiic_tpu_torch/csrc/int8_attention.cu",
        "replaces": "aiic_tpu/ops/quant.py:353",
    },
    "int8_ln_mlp": {
        "source": "aiic_tpu_torch/csrc/int8_mlp.cu",
        "replaces": "aiic_tpu/ops/quant.py:102",
    },
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
    return p


def _calls(p):
    """(kernel wrapper call, plain call) per kernel on one input set."""
    from aiic_tpu_torch.ops import quant

    attn_args = (p["x"], p["ln_s"], p["ln_b"], p["wqkv_q"], p["sqkv"], p["bqkv"],
                 p["wo"], p["bo"], p["mask"])
    mlp_args = (p["x"], p["ln_s"], p["ln_b"], p["w1_q"], p["s1"], p["b1"],
                p["w2_q"], p["s2"], p["b2"])
    return {
        "int8_ln_qkv_attention": (
            lambda: quant.int8_ln_qkv_attention(*attn_args, heads=p["heads"]),
            lambda: quant.int8_ln_qkv_attention_ref(*attn_args, heads=p["heads"])),
        "int8_ln_mlp": (
            lambda: quant.int8_ln_mlp(*mlp_args),
            lambda: quant.int8_ln_mlp_ref(*mlp_args)),
    }


def _agreement(out, ref) -> dict:
    import torch

    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    err = (o - r).abs()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp(min=2.0 ** -126))) - 7)
    cos = torch.nn.functional.cosine_similarity(o, r, dim=-1)
    return {
        "max_abs_err": float(err.max()),
        "within_2ulp": float((err <= 2 * ulp).float().mean()),
        "min_row_cos": float(cos.min()),
        "finite": bool(torch.isfinite(o).all()),
    }


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
    worst = {name: 0.0 for name in KERNELS}
    results = []
    for label, kw in cases:
        p = _half_block_inputs(rng, device=device, **kw)
        for name, (kernel, plain) in _calls(p).items():
            out = kernel()
            torch.cuda.synchronize()
            ref = plain()
            a = _agreement(out, ref)
            a.update(kernel=name, case=label)
            results.append(a)
            log(f"[kernels] {name:22s} {label:20s} max_abs_err={a['max_abs_err']:.6g} "
                f"within_2ulp={a['within_2ulp']:.6f} min_row_cos={a['min_row_cos']:.8f}")
            if not (a["finite"] and a["min_row_cos"] >= COS_MIN
                    and a["within_2ulp"] >= ULP_SHARE):
                raise AssertionError(f"{name} disagrees with its plain version on {label}: {a}")
            worst[name] = max(worst[name], a["max_abs_err"])
    REPORT["kernel_checks"] = results
    return worst


# ---------------------------------------------------------------------------
# Phases 4-5: the slice, and the CPU comparison
# ---------------------------------------------------------------------------


def _pixels(rng, n, size):
    return rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def phase_slice(device):
    import torch

    from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer
    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.models.init import init_clip_params
    from aiic_tpu_torch.ops import quant

    gen = torch.Generator(device=device).manual_seed(0)
    params = init_clip_params(VIT_B_16, gen, device=device)
    rng = np.random.default_rng(1)
    requests = [_pixels(rng, n, VIT_B_16.image_size) for n in (1, 7, 64)]

    quant.reset_launch_counts()
    t0 = time.perf_counter()
    engine = InteriorAnalyzer(params, VIT_B_16, training_data=TRAINING_DATA,
                              dtype=torch.bfloat16, quantize=True,
                              wire_format="patch", device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    at_build = {"int8_ln_qkv_attention": quant.int8_ln_qkv_attention.launches,
                "int8_ln_mlp": quant.int8_ln_mlp.launches}
    # the 7-image request unfiltered, so the attribute branch runs too
    answers = [engine.analyze_pixels(px, filter_interiors=len(px) != 7) for px in requests]
    torch.cuda.synchronize()
    launches = {"int8_ln_qkv_attention": quant.int8_ln_qkv_attention.launches,
                "int8_ln_mlp": quant.int8_ln_mlp.launches}

    text_layers = VIT_B_16.text.layers
    image_layers = VIT_B_16.vision.layers - 1  # the last block is the CLS-row block
    want_build = text_layers  # one text batch of all prompts
    chunks = sum(-(-len(px) // engine.max_batch) for px in requests)
    want = want_build + image_layers * chunks
    log(f"[slice] engine built in {build_s:.3f} s; {len(engine.category_names)} categories, "
        f"{engine.det_text.shape[0]} detector prompts; launches at build {at_build}, "
        f"after requests {launches} (expected {want_build} and {want} each)")
    for name in KERNELS:
        if at_build[name] != want_build or launches[name] != want:
            raise AssertionError(f"{name}: {launches[name]} launches, expected {want}")
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
    log(f"[slice] answered {[len(px) for px in requests]} images; {sum(verdicts)} of "
        f"{len(verdicts)} filtered ones judged interior; all outputs finite")
    REPORT["slice"] = {"build_s": build_s, "launches": launches, "expected": want}
    return engine, params, launches


def phase_cpu_compare(engine, params) -> None:
    import torch

    from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer
    from aiic_tpu_torch.models.init import tree_map

    cpu_params = tree_map(lambda t: t.cpu(), params)
    t0 = time.perf_counter()
    cpu = InteriorAnalyzer(cpu_params, engine.config, training_data=TRAINING_DATA,
                           dtype=torch.bfloat16, quantize=True,
                           wire_format="patch", device="cpu")
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
    log(f"[cpu] plain CPU path vs card on 4 images ({time.perf_counter() - t0:.1f} s): "
        f"min feature cosine {cos.min():.6f}, min detector-text cosine {text_cos:.6f}, "
        f"verdicts equal {same_verdict}, top-1 equal {same_top1}; "
        f"top_conf card {np.round(a['top_conf'], 5).tolist()} cpu {np.round(b['top_conf'], 5).tolist()}")
    REPORT["cpu_compare"] = {"min_feature_cos": float(cos.min()), "min_text_cos": text_cos,
                             "same_verdict": same_verdict, "same_top1": same_top1}
    if cos.min() < 0.999 or not same_verdict or not same_top1:
        raise AssertionError(f"card and CPU disagree: {REPORT['cpu_compare']}")


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


def phase_timing(device, card: str, engine) -> dict:
    import torch

    from aiic_tpu_torch.ops import quant

    p = _half_block_inputs(np.random.default_rng(3), 256, 197, 768, 12,
                           mask=False, zero_row=False, device=device)
    times = {}
    saved = (quant.int8_ln_qkv_attention.launches, quant.int8_ln_mlp.launches)
    for name, (kernel, plain) in _calls(p).items():
        # plain, kernel, kernel, plain on one card
        t_plain = [_time_ms(plain, 3)]
        t_kernel = [_time_ms(kernel, 10), _time_ms(kernel, 10)]
        t_plain.append(_time_ms(plain, 3))
        times[name] = {"ms": min(t_kernel), "plain_ms": min(t_plain)}
        log(f"[timing] {name:22s} B=256 S=197 W=768: kernel {min(t_kernel):.3f} ms, "
            f"plain {min(t_plain):.3f} ms ({card})")
    quant.int8_ln_qkv_attention.launches, quant.int8_ln_mlp.launches = saved
    rng = np.random.default_rng(4)
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
    p50 = float(np.percentile(lat, 50))
    log(f"[timing] classify_pixels B=256: {ips:.1f} images/s; single image p50 {p50:.3f} ms ({card})")
    times["classify"] = {"images_per_s_b256": ips, "single_image_p50_ms": p50}
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
    engine, params, launches = phase_slice(device)
    phase_cpu_compare(engine, params)
    times = phase_timing(device, card, engine)

    kernels = [{"name": name, "route": "cuda", **meta, "launches": launches[name],
                "max_abs_err": worst[name], **times[name]} for name, meta in KERNELS.items()]
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
