"""Kernel experiments on the card: the port's twin of
``tools/kernel_experiments{,2,3,4,5,7}.py``.

    python -m aiic_tpu_torch.probes.kernel_experiments N [iters] [inner] [variants]

N is the tool's number (1, 2, 3, 4, 5 or 7); ``variants`` a comma list
(default: the tool's). Each experiment times the 12-layer ViT-B/16 stack of
each variant (``probes/variants.py``) against ``prod``, the port's rows 1-2
(``ops.quant.int8_ln_qkv_attention`` / ``int8_ln_mlp``), on the port's
seeded ViT-B/16 init cast to bf16 and quantized as the tools do, and
x (B, 197, 768) bf16 from ``numpy.random.default_rng(0)``:

- 1: attention ``prod``/``nomax`` and MLP ``prod``/``static`` stacks at
  B=256; then the int8 ``classify_batch`` program (HWC uint8 pixels, 40
  detector and 5 x 304 category embeddings) at B=256 and 512;
- 2, 4, 5: attention stacks at B=256; 3: MLP stacks at B=256; 7: attention
  stacks at B=1024.

Timing: one warm-up stack, then ``iters`` times ``inner`` chained stacks
between two CUDA events; ms per stack (the minimum and the mean of the
``iters``). Each REAL candidate's cosine against ``prod`` is taken as its
tool takes it: on 4 images through one stack (2, 3, 4, 5), or on the whole
batch through ``inner`` chained stacks (7). The variants run their form 0,
rows 1-2's current design (the ``wgmma`` + TMA GEMM stage and a tensor-core
core), so ``prod - variant`` (``attribution``, printed after the stacks)
prices what the variant removes or changes in rows 1-2: experiment 4 LN1,
the softmax and the core, experiment 3 the gelu, LN2 and the quantizers.
The run prints the card's ``nvidia-smi`` line and ends with one JSON line.
It raises without a card: a CPU timing is not a kernel time.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from aiic_tpu_torch.models.config import VIT_B_16
from aiic_tpu_torch.models.init import init_clip_params, tree_map
from aiic_tpu_torch.ops import quant
from aiic_tpu_torch.probes import variants
from aiic_tpu_torch.probes.mxu_probe import card_line

# The tools' variant lists, defaults and checks. "half" picks prod's kernel;
# "real" are the variants whose cosine against prod the tool prints.
EXPERIMENTS: Dict[int, dict] = {
    1: {"tool": "tools/kernel_experiments.py", "batch": 256, "inner": 8,
        "variants": ("prod_attn", "nomax", "prod_mlp", "static"), "real": (), "check": None},
    2: {"tool": "tools/kernel_experiments2.py", "batch": 256, "inner": 8, "wrapper": "attn_var2",
        "variants": ("prod", "v1", "v2", "v3", "v4"), "real": ("v1", "v2", "v3", "v4"),
        "check": "four"},
    3: {"tool": "tools/kernel_experiments3.py", "batch": 256, "inner": 8, "wrapper": "mlp_var3",
        "variants": ("prod", "nogelu", "noln", "noq", "maconly", "macbf16", "q2bf16", "gelu2",
                     "gelubf16"), "real": ("q2bf16", "gelu2", "gelubf16"), "check": "four"},
    4: {"tool": "tools/kernel_experiments4.py", "batch": 256, "inner": 8, "wrapper": "attn_var4",
        "variants": ("prod", "noln", "nosm", "nocore", "maconly", "qobf16"), "real": ("qobf16",),
        "check": "four"},
    5: {"tool": "tools/kernel_experiments5.py", "batch": 256, "inner": 8, "wrapper": "attn_var5",
        "variants": ("prod", "gbatch", "hstack", "hg"), "real": ("gbatch", "hstack", "hg"),
        "check": "four"},
    7: {"tool": "tools/kernel_experiments7.py", "batch": 1024, "inner": 4, "wrapper": "attn_var7",
        "variants": ("prod", "coreqk", "corepv", "coreboth"),
        "real": ("coreqk", "corepv", "coreboth"), "check": "chained"},
}
_EXP1 = {"prod_attn": ("attn", None), "nomax": ("attn", "int8_attn_nomax"),
         "prod_mlp": ("mlp", None), "static": ("mlp", "mlp_var")}
CLASSIFY_BATCHES = (256, 512)


def model(device, seed: int = 0):
    """The tools' model: the seeded ViT-B/16 init cast to bf16 and quantized;
    (params, the vision tower's ``layer_params``)."""
    params = init_clip_params(VIT_B_16, torch.Generator(device=device).manual_seed(seed),
                              device=device)
    params = quant.quantize_model(tree_map(lambda t: t.to(torch.bfloat16), params))
    return params, variants.layer_params(params["visual"]["blocks"], VIT_B_16.vision.heads)


def _layer(half: str, wrapper: Optional[str], variant: str):
    """x, lp -> one block's half in this variant (prod: the port's rows 1-2)."""
    if wrapper is not None:
        fn = variants.WRAPPERS[wrapper]
        return lambda x, lp: fn(x, lp, variant)
    if half == "attn":
        return lambda x, lp: quant.int8_ln_qkv_attention(
            x, lp["ln1_s"], lp["ln1_b"], lp["wqkv_q"], lp["sqkv"], lp["bqkv"], lp["wo"],
            lp["bo"], None, heads=lp["heads"])
    return lambda x, lp: quant.int8_ln_mlp(x, lp["ln2_s"], lp["ln2_b"], lp["w1_q"], lp["s1"],
                                           lp["b1"], lp["w2_q"], lp["s2"], lp["b2"])


def _stack_fn(exp: int, variant: str, layers: List[dict]):
    if exp == 1:
        half, wrapper = _EXP1[variant]
    else:
        e = EXPERIMENTS[exp]
        half = "mlp" if e["wrapper"].startswith("mlp") else "attn"
        wrapper = None if variant == "prod" else e["wrapper"]
    layer = _layer(half, wrapper, variant)

    def stack(x):
        for lp in layers:
            x = layer(x, lp)
        return x
    return stack


def attribution(exp: int, res: dict) -> Dict[str, float]:
    """ms per 12-layer stack that each variant saves against prod (``prod -
    variant``, the minima; negative where the variant is slower), from
    ``run_experiment``'s result: experiment 1 against ``prod_attn`` and
    ``prod_mlp``, the others against ``prod``."""
    if exp == 1:
        pairs = {"nomax": "prod_attn", "static": "prod_mlp"}
    else:
        pairs = {v: "prod" for v in EXPERIMENTS[exp]["variants"] if v != "prod"}
    return {v: res[p]["ms"] - res[v]["ms"] for v, p in pairs.items() if v in res and p in res}


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def _events(fn, x, inner: int, iters: int) -> List[float]:
    """ms per call of ``fn``, ``inner`` calls chained between two CUDA
    events, ``iters`` times."""
    out = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        y = x
        start.record()
        for _ in range(inner):
            y = fn(y)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return out


def _classify(params, device, batch: int, inner: int, iters: int, rng) -> dict:
    """kernel_experiments.py ``full_at``: the int8 classify program on HWC
    uint8 pixels, ``inner`` calls on ``px ^ i`` summed on the device."""
    from aiic_tpu_torch.engine.programs import classify_batch

    cfg = VIT_B_16
    det = rng.standard_normal((40, cfg.embed_dim)).astype(np.float32)
    det = torch.from_numpy(det / np.linalg.norm(det, axis=-1, keepdims=True)).to(device)
    cat = torch.from_numpy(rng.standard_normal((5, 304, cfg.embed_dim)).astype(np.float32)).to(device)
    mask = torch.ones((5, 304), dtype=torch.bool, device=device)
    px = torch.from_numpy(rng.integers(0, 256, (batch, 224, 224, 3), dtype=np.uint8)).to(device)

    def loop():
        acc = torch.zeros((), device=device)
        for i in range(inner):
            out = classify_batch(params, torch.bitwise_xor(px, i), det, cat, mask, config=cfg,
                                 interior_count=11, dtype=torch.bfloat16, attn_impl="pallas")
            acc = acc + out["interior_mass"].sum() + out["topk_vals"].sum()
        return acc

    float(loop())
    ms = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        total = loop()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / inner)
    return {"ms": min(ms), "ms_mean": float(np.mean(ms)), "images_per_s": batch / min(ms) * 1e3,
            "calls": inner * (1 + iters), "finite": bool(torch.isfinite(total))}


def run_experiment(exp: int, iters: int = 5, inner: Optional[int] = None,
                   only: Optional[List[str]] = None, device=None, built=None) -> dict:
    """One experiment; returns {variant: {ms, ms_mean, stacks[, cosine]},
    "classify": {...} (1), "batch", "inner", "iters"}. ``stacks`` counts the
    12-layer stacks run (each launches the variant's kernel once a layer).
    ``built`` reuses a ``model(device)``."""
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_experiments: needs a CUDA card; a CPU timing is not a kernel "
                           "time")
    e = EXPERIMENTS[exp]
    device = device or torch.device("cuda", 0)
    inner = inner or e["inner"]
    names = tuple(only) if only else e["variants"]
    unknown = set(names) - set(e["variants"])
    if unknown:
        raise ValueError(f"experiment {exp} runs {e['variants']}, not {sorted(unknown)}")
    params, layers = built or model(device)
    rng = np.random.default_rng(0)
    cfg = VIT_B_16
    seq = cfg.vision_seq_len
    x = torch.from_numpy(rng.standard_normal((e["batch"], seq, cfg.vision.width))
                         .astype(np.float32)).to(device, torch.bfloat16)
    res: dict = {"batch": e["batch"], "inner": inner, "iters": iters}
    ref = None
    if e["check"] == "four" and set(names) & set(e["real"]):
        ref = _stack_fn(exp, "prod", layers)(x[:4])
    for v in names:
        stack = _stack_fn(exp, v, layers)
        r: dict = {"stacks": 0}
        if e["check"] == "chained":
            y = x
            for _ in range(inner):
                y = stack(y)
            r["stacks"] += inner
            if v == "prod":
                ref = y
            if v in e["real"] and ref is not None:
                r["cosine"] = _cosine(y, ref)
            r["finite"] = bool(torch.isfinite(y.float()).all())
            del y
        stack(x)
        torch.cuda.synchronize()
        ms = _events(stack, x, inner, iters)
        r["stacks"] += 1 + inner * iters
        r.update(ms=min(ms), ms_mean=float(np.mean(ms)))
        if e["check"] == "four" and v in e["real"]:
            r["cosine"] = _cosine(stack(x[:4]), ref)
            r["stacks"] += 1
        res[v] = r
        cos = f"  cosine vs prod {r['cosine']:.6f}" if "cosine" in r else ""
        print(f"exp {exp} B={e['batch']} [{v:9s}] {r['ms']:9.3f} ms/stack (mean "
              f"{r['ms_mean']:.3f}){cos}", flush=True)
    if e["check"] == "four" and ref is not None:
        res["prod_check_stacks"] = 1
    res["attribution"] = attribution(exp, res)
    for v, d in res["attribution"].items():
        print(f"exp {exp} B={e['batch']} prod - {v:9s} {d:9.3f} ms/stack", flush=True)
    if exp == 1 and not only:
        res["classify"] = {}
        for b in CLASSIFY_BATCHES:
            c = res["classify"][b] = _classify(params, device, b, inner, iters, rng)
            print(f"exp 1 full program B={b:4d} {c['ms']:9.3f} ms/call -> "
                  f"{c['images_per_s']:.1f} images/s", flush=True)
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or int(argv[0]) not in EXPERIMENTS:
        raise SystemExit(f"usage: python -m aiic_tpu_torch.probes.kernel_experiments "
                         f"{{{','.join(map(str, EXPERIMENTS))}}} [iters] [inner] [variants]")
    exp = int(argv[0])
    iters = int(argv[1]) if len(argv) > 1 else 5
    inner = int(argv[2]) if len(argv) > 2 else None
    only = argv[3].split(",") if len(argv) > 3 else None
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_experiments: needs a CUDA card; a CPU timing is not a kernel "
                           "time")
    card = card_line()
    print(f"experiment {exp} ({EXPERIMENTS[exp]['tool']}) iters={iters}; {card}", flush=True)
    res = run_experiment(exp, iters, inner, only)
    print(json.dumps({"experiment": exp, "card": card, "results": res}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
