#!/usr/bin/env python3
"""First card check of the whole-text-block kernels (``text_block_fwd``,
``text_block_bwd``, and with ``--int8`` ``text_block_fwd_int8``,
``text_block_bwd_int8``): build, compare with the plain versions, rough times.

    python3 tools/text_block_probe.py [--int8]

At the B/16 text shape (S=77, W=512, M=2048, H=8, rank 16, causal mask):
prints the card's name and power limit, the compiler's register report,
each kernel's error against its plain version at B = 1, 7, 64 in fp32 and
bf16 (max |err| / max(max |plain|, 1) and the minimum row cosine for y and
dx; max |err| / max |plain| for each LoRA cotangent), CUDA-event times of
the kernels and of the plain forward at B=256 (3 calls after one warm call),
and a profiler table of one backward's launches. ``--int8``: the int8 pair
instead (B = 1, 7 at B/16; B = 7 at the L/14 text width on its chunked plan;
the int8 transposed product alone at an odd row count against an exact one;
the bf16 pair once at B=7), with the same times and profile. Needs a CUDA card. ``chip_smoke.py`` holds the
kernels to their bars; this is the quick look after a change.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

S, W, M, H, RANK = 77, 512, 2048, 8, 16


def _inputs(rng, bsz, dtype, dev, W=W, M=M):
    import torch

    def f(*s, std=1.0):
        return torch.from_numpy((rng.standard_normal(s) * std).astype(np.float32)).to(dev)

    bp = {"ln1": {"scale": 1 + f(W, std=0.1), "bias": f(W, std=0.1)},
          "ln2": {"scale": 1 + f(W, std=0.1), "bias": f(W, std=0.1)},
          "attn": {"wqkv": f(W, 3 * W, std=W ** -0.5), "bqkv": f(3 * W, std=0.1),
                   "wo": f(W, W, std=W ** -0.5), "bo": f(W, std=0.1)},
          "mlp": {"w1": f(W, M, std=W ** -0.5), "b1": f(M, std=0.1),
                  "w2": f(M, W, std=M ** -0.5), "b2": f(W, std=0.1)}}
    dims = {"out_proj": (W, W), "c_fc": (W, M), "c_proj": (M, W)}
    lora = {p: {"A": f(dims[p][0], RANK, std=0.02), "B": f(RANK, dims[p][1], std=0.02)}
            for p in dims}
    return f(bsz, S, W).to(dtype), f(bsz, S, W, std=0.01).to(dtype), bp, lora


def _err(a, b):
    import torch

    a, b = a.float(), b.float()
    return (float((a - b).abs().max() / b.abs().max().clamp(min=1.0)),
            float(torch.nn.functional.cosine_similarity(a.flatten(0, -2), b.flatten(0, -2),
                                                        dim=-1).min()))


def _time(fn):
    import torch

    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(3):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / 3


def int8_main(dev, mask, rng) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _quantized
    from aiic_tpu_torch.ops import block_grad

    a = torch.randint(-127, 128, (77, 3072), dtype=torch.int8, device=dev)
    b = torch.randint(-127, 128, (768, 3072), dtype=torch.int8, device=dev)
    got = block_grad.int8_matmul_t_cuda(a, b, 512)
    want = torch.stack([(a[:, i:i + 512].double() @ b[:, i:i + 512].double().t()).int()
                        for i in range(0, 3072, 512)])
    print("int8 A.B^T, 77 rows, 6 splits: exact", bool((got == want).all()), flush=True)
    kw = dict(heads=H, scaling=2.0)
    x, dy, bp, lora = _inputs(rng, 7, torch.bfloat16, dev)
    dx, dl = block_grad.text_block_bwd(x, dy, mask, bp, lora, **kw)
    dxr, _ = block_grad.text_block_bwd_ref(x, dy, mask, bp, lora, **kw)
    print("bf16 pair B=7 dx", _err(dx, dxr), flush=True)
    for bsz, w, m, heads, plan in ((1, W, M, H, None), (7, W, M, H, None),
                                   (7, 768, 3072, 12, (1, 6))):
        x, dy, bp, lora = _inputs(rng, bsz, torch.bfloat16, dev, W=w, M=m)
        qw = _quantized(bp)
        kw = dict(heads=heads, scaling=2.0, force_plan=plan)
        y = block_grad.text_block_fwd_int8(x, mask, bp, qw, lora, **kw)
        dx, dl = block_grad.text_block_bwd_int8(x, dy, mask, bp, qw, lora, **kw)
        torch.cuda.synchronize()
        n = 1 if plan is None else plan[1]
        kr = dict(heads=heads, scaling=2.0, n_chunks=n)
        yr = block_grad.text_block_fwd_int8_ref(x, mask, bp, qw, lora, **kr)
        dxr, dlr = block_grad.text_block_bwd_int8_ref(x, dy, mask, bp, qw, lora, **kr)
        res = {"y": _err(y, yr), "dx": _err(dx, dxr)}
        for p in dl:
            for ab in "AB":
                res[p + ab] = float(torch.nn.functional.cosine_similarity(
                    dl[p][ab].flatten(), dlr[p][ab].flatten(), dim=0))
        print("int8", bsz, w, plan, res, flush=True)
    x, dy, bp, lora = _inputs(rng, 256, torch.bfloat16, dev)
    qw = _quantized(bp)
    kw = dict(heads=H, scaling=2.0)
    for name, fn in [
            ("fwd_int8", lambda: block_grad.text_block_fwd_int8(x, mask, bp, qw, lora, **kw)),
            ("bwd_int8", lambda: block_grad.text_block_bwd_int8(x, dy, mask, bp, qw, lora, **kw)),
            ("fwd_int8_ref", lambda: block_grad.text_block_fwd_int8_ref(x, mask, bp, qw, lora,
                                                                        **kw))]:
        print(name, _time(fn), "ms", flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        block_grad.text_block_bwd_int8(x, dy, mask, bp, qw, lora, **kw)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30,
                                    max_name_column_width=90))
    return 0


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aiic_tpu_torch.models.clip import causal_mask
    from aiic_tpu_torch.ops import _build, block_grad

    if not torch.cuda.is_available():
        raise SystemExit("text_block_probe: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    t0 = time.time()
    _build.load_library()
    print("build", time.time() - t0, flush=True)
    print("\n".join(line for line in _build.BUILD_INFO["log"].splitlines()
                    if "Used" in line or "spill" in line)[-6000:], flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    mask = causal_mask(S, device=dev)
    if "--int8" in sys.argv[1:]:
        return int8_main(dev, mask, rng)
    kw = dict(heads=H, scaling=2.0)
    for dtype in (torch.float32, torch.bfloat16):
        for bsz in (1, 7, 64):
            x, dy, bp, lora = _inputs(rng, bsz, dtype, dev)
            y = block_grad.text_block_fwd(x, mask, bp, lora, **kw)
            dx, dl = block_grad.text_block_bwd(x, dy, mask, bp, lora, **kw)
            torch.cuda.synchronize()
            yr = block_grad.text_block_fwd_ref(x, mask, bp, lora, **kw)
            dxr, dlr = block_grad.text_block_bwd_ref(x, dy, mask, bp, lora, **kw)
            res = {"y": _err(y, yr), "dx": _err(dx, dxr)}
            for p in dl:
                for ab in "AB":
                    res[p + ab] = float((dl[p][ab] - dlr[p][ab]).abs().max()
                                        / dlr[p][ab].abs().max())
            print(dtype, bsz, res, flush=True)

    for dtype in (torch.float32, torch.bfloat16):
        x, dy, bp, lora = _inputs(rng, 256, dtype, dev)
        for name, fn in [("fwd", lambda: block_grad.text_block_fwd(x, mask, bp, lora, **kw)),
                         ("bwd", lambda: block_grad.text_block_bwd(x, dy, mask, bp, lora, **kw)),
                         ("fwd_ref",
                          lambda: block_grad.text_block_fwd_ref(x, mask, bp, lora, **kw))]:
            print(dtype, name, _time(fn), "ms", flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            block_grad.text_block_bwd(x, dy, mask, bp, lora, **kw)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                        max_name_column_width=90))
    return 0


if __name__ == "__main__":
    sys.exit(main())
