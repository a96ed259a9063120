"""Tensor-core rate probe: the port's twin of ``tools/mxu_probe.py``.

    python -m aiic_tpu_torch.probes.mxu_probe [reps]     # needs one CUDA card

Times three hand-written products at the TPU probe's geometry: x of STEPS·R
rows by W against a (W, M) weight, INNER products per row block, each with
an i-dependent operand so that none is hoisted out of the loop:

- ``mxu_bf16``: acc += bf16(x + i)·w, bf16 operands into fp32, bf16 out;
- ``mxu_i8``: acc += (x ^ i)·w, int8 into int32;
- ``mxu_i8_quant``: x + i quantized per row (amax/127, 1e-6 floor, ±127
  clip, round half to even), the int8 product dequantized into fp32, bf16
  out.

Each body has two forms on the card: ``"wgmma"`` (``csrc/mxu_probe_wgmma.cu``:
TMA into swizzled shared memory on an mbarrier ring, warpgroup products
from ``csrc/wgmma_gemm.cuh``; the public wrappers' route) and ``"wmma"``
(``csrc/mxu_probe.cu``: the serving GEMMs' WMMA tile, the form it
replaced, reachable through ``_probe_cuda(..., form="wmma")`` and uncounted).

It prints each body's ms and TFLOP/s (TOP/s for int8) against the card's
dense peak (989.4 bf16, 1,978.9 int8, at 700 W), beside the WMMA form's ms
and the library time of the same INNER products (``torch.matmul`` in bf16,
``torch._int_mm`` in int8, with w row-major and column-major), which the port
never calls, then one JSON line.

Each wrapper launches its kernel for a CUDA tensor and takes its plain
version (``mxu_*_ref``) for a CPU one.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch

from aiic_tpu_torch.ops._build import check, counted, load_library, ptr, route
from aiic_tpu_torch.ops.attention import no_tf32

R, W, M = 128, 768, 3072  # rows per TPU grid step, the MLP geometry
STEPS = 64  # row blocks
INNER = 64  # products per row block
PEAK_OPS = {"bf16": 989.4e12, "int8": 1978.9e12}  # NVIDIA H100 SXM5, dense
_BODIES = {"mxu_bf16": 0, "mxu_i8": 1, "mxu_i8_quant": 2}
# x, w and out dtypes of each body
_TYPES = {"mxu_bf16": (torch.bfloat16, torch.bfloat16, torch.bfloat16),
          "mxu_i8": (torch.int8, torch.int8, torch.int32),
          "mxu_i8_quant": (torch.bfloat16, torch.int8, torch.bfloat16)}
FORMS = ("wgmma", "wmma")  # the public wrappers' route, then the form it replaced
_QUANT_MAX_W = 768  # the wgmma i8_quant kernel keeps 256 columns of w^T (256·W bytes) resident


def inputs(device, steps: int = STEPS, seed: int = 0):
    """x_bf (steps·R, W) bf16, x_i8 int8, w_bf (W, M) bf16, w_i8 int8, made
    from ``seed`` as the TPU probe makes them."""
    rng = np.random.default_rng(seed)
    x_bf = torch.from_numpy(rng.standard_normal((steps * R, W)).astype(np.float32))
    x_i8 = torch.from_numpy(rng.integers(-127, 127, (steps * R, W)).astype(np.int8))
    w_bf = torch.from_numpy((rng.standard_normal((W, M)) * 0.05).astype(np.float32))
    w_i8 = torch.from_numpy(rng.integers(-127, 127, (W, M)).astype(np.int8))
    return (x_bf.to(device, torch.bfloat16), x_i8.to(device), w_bf.to(device, torch.bfloat16),
            w_i8.to(device))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _exact_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b of integer-valued tensors, exact: float64 holds every partial sum
    (|sum| <= W·127² < 2^53)."""
    return a.double() @ b.double()


def mxu_bf16_ref(x: torch.Tensor, w: torch.Tensor, inner: int) -> torch.Tensor:
    """bf16(sum_i fp32(bf16(x + i)·w)), each product summed in fp32 (TF32
    off) and added to the running fp32 sum."""
    no_tf32()
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    for i in range(inner):
        acc = acc + (x + i).float() @ w.float()
    return acc.to(torch.bfloat16)


def mxu_i8_ref(x: torch.Tensor, w: torch.Tensor, inner: int) -> torch.Tensor:
    """int32(sum_i (x ^ i)·w), exact."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float64, device=x.device)
    for i in range(inner):
        acc = acc + _exact_mm(torch.bitwise_xor(x, i), w)
    return acc.to(torch.int32)


def quant_scale(x: torch.Tensor, i: int) -> torch.Tensor:
    """The (rows, 1) scales of ``mxu_i8_quant_ref`` at product i:
    max(amax|f32(x) + i|, 1e-6)/127 over each row. The 127 is a tensor:
    PyTorch's CUDA division by a Python scalar multiplies by its rounded
    reciprocal instead of dividing."""
    xf = x.float() + float(i)
    return (torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-6)
            / torch.tensor(127.0, device=x.device))


def quant_scales_from_extremes(x: torch.Tensor, inner: int) -> torch.Tensor:
    """(inner, rows) scales as the wgmma form's row pass takes them: from
    each row's max and min alone, max(|fl(max + i)|, |fl(min + i)|) for
    amax (fl(x + i) is monotone in x), bit for bit ``quant_scale``."""
    xf = x.float()
    hi, lo = xf.amax(dim=-1), xf.amin(dim=-1)
    c127 = torch.tensor(127.0, device=x.device)
    return torch.stack([torch.clamp(torch.maximum((hi + float(i)).abs(), (lo + float(i)).abs()),
                                    min=1e-6) / c127 for i in range(inner)])


def mxu_i8_quant_ref(x: torch.Tensor, w: torch.Tensor, inner: int) -> torch.Tensor:
    """bf16(sum_i fp32(q_i·w)·s_i): xf = f32(x) + i, s_i = ``quant_scale``,
    q_i = clip(round(xf / s_i), ±127); the int8 product exact."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    for i in range(inner):
        xf = x.float() + float(i)
        scale = quant_scale(x, i)
        q = torch.clamp(torch.round(xf / scale), -127.0, 127.0)
        acc = acc + _exact_mm(q, w).float() * scale
    return acc.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# The kernels (csrc/mxu_probe.cu)
# ---------------------------------------------------------------------------


def _probe_cuda(name: str, x: torch.Tensor, w: torch.Tensor, inner: int,
                form: str = "wgmma") -> torch.Tensor:
    """One body on the card in one of its forms (``FORMS``): the wgmma form
    needs rows % 128 (i8_quant: % 64), M % 256 and W % 64 in bf16 or % 128
    in int8 (i8_quant also W <= 768); the WMMA form rows % 128, M % 128 and
    W % 32. Raises ValueError on anything else before the library loads."""
    if form not in FORMS:
        raise ValueError(f"{name}: no {form!r} form (forms {list(FORMS)})")
    xdtype, wdtype, odtype = _TYPES[name]
    if x.dtype != xdtype or w.dtype != wdtype or x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name}: the kernel takes {xdtype} x (rows, W) and {wdtype} w (W, M), "
                         f"got {x.dtype} {tuple(x.shape)} and {w.dtype} {tuple(w.shape)}")
    rows, depth = x.shape
    cols = w.shape[1]
    quant = name == "mxu_i8_quant"
    if form == "wgmma":
        row_tile, col_tile = (64 if quant else 128), 256
        depth_tile = 64 if wdtype == torch.bfloat16 else 128
    else:
        row_tile, col_tile, depth_tile = 128, 128, 32
    if (w.shape[0] != depth or rows % row_tile or cols % col_tile or depth % depth_tile
            or inner < 1 or w.device != x.device
            or (form == "wgmma" and quant and depth > _QUANT_MAX_W)):
        raise ValueError(f"{name}: the {form} form needs rows % {row_tile} == 0, W % {depth_tile} "
                         f"== 0, M % {col_tile} == 0"
                         + (f", W <= {_QUANT_MAX_W}" if form == "wgmma" and quant else "")
                         + f", inner >= 1 and w on x's device, got x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} on {w.device}, inner {inner}")
    lib = load_library()
    x, w = x.contiguous(), w.contiguous()
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: x and w must be 16-byte aligned")
    out = torch.empty((rows, cols), dtype=odtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if form == "wmma":
        rc = lib.aiic_mxu_probe(ptr(x), ptr(w), ptr(out), rows, depth, cols, inner, _BODIES[name],
                                stream)
    else:
        # 8-bit wgmma takes K-major operands only: the int8 bodies read w^T.
        wk = w.t().contiguous() if wdtype == torch.int8 else w
        xq = scales = None
        if quant:  # the row pass's workspace: q_i (inner·rows, W) int8 and s_i (inner·rows)
            xq = torch.empty((inner * rows, depth), dtype=torch.int8, device=x.device)
            scales = torch.empty(inner * rows, dtype=torch.float32, device=x.device)
        rc = lib.aiic_mxu_probe_wgmma(ptr(x), ptr(wk), ptr(out), ptr(xq), ptr(scales), rows, depth,
                                      cols, inner, _BODIES[name], stream)
    check(name, rc)
    return out


def wgmma_occupancy() -> Dict[str, int]:
    """Blocks of the wgmma form's product kernels resident on one SM."""
    blocks = (ctypes.c_int * 3)()
    check("mxu_probe_wgmma occupancy", load_library().aiic_mxu_probe_wgmma_occupancy(blocks))
    return {"mxu_bf16": blocks[0], "mxu_i8": blocks[1], "mxu_i8_quant": blocks[2]}


@counted
def mxu_bf16(x: torch.Tensor, w: torch.Tensor, inner: int = INNER) -> torch.Tensor:
    if not route("mxu_bf16", x):
        return mxu_bf16_ref(x, w, inner)
    out = _probe_cuda("mxu_bf16", x, w, inner)
    mxu_bf16.launches += 1
    return out


@counted
def mxu_i8(x: torch.Tensor, w: torch.Tensor, inner: int = INNER) -> torch.Tensor:
    if not route("mxu_i8", x):
        return mxu_i8_ref(x, w, inner)
    out = _probe_cuda("mxu_i8", x, w, inner)
    mxu_i8.launches += 1
    return out


@counted
def mxu_i8_quant(x: torch.Tensor, w: torch.Tensor, inner: int = INNER) -> torch.Tensor:
    if not route("mxu_i8_quant", x):
        return mxu_i8_quant_ref(x, w, inner)
    out = _probe_cuda("mxu_i8_quant", x, w, inner)
    mxu_i8_quant.launches += 1
    return out


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------


def _events_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` calls between two CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bodies(x_bf, x_i8, w_bf, w_i8, inner: int = INNER) -> Dict[str, tuple]:
    """name -> (kernel call, WMMA-form call, {w layout: library call},
    operand type) on one input set. The kernel call is the public wrapper
    (counted); the WMMA form is the one it replaced (uncounted). Each library
    call makes the same ``inner`` products, one PyTorch call each, on x
    itself. ``torch._int_mm`` is given w both row-major and column-major (the
    layout cuBLASLt's int8 kernels take without a transpose); the faster one
    stands as the library's time."""
    def products(fn, a, b):
        def call():
            for _ in range(inner):
                fn(a, b)
        return call

    def wmma(name, x, w):
        return lambda: _probe_cuda(name, x, w, inner, "wmma")

    w_i8_cols = w_i8.t().contiguous().t()
    return {
        "mxu_bf16": (lambda: mxu_bf16(x_bf, w_bf, inner), wmma("mxu_bf16", x_bf, w_bf),
                     {"row-major": products(torch.matmul, x_bf, w_bf)}, "bf16"),
        "mxu_i8": (lambda: mxu_i8(x_i8, w_i8, inner), wmma("mxu_i8", x_i8, w_i8),
                   {"row-major": products(torch._int_mm, x_i8, w_i8),
                    "column-major": products(torch._int_mm, x_i8, w_i8_cols)}, "int8"),
        "mxu_i8_quant": (lambda: mxu_i8_quant(x_bf, w_i8, inner), wmma("mxu_i8_quant", x_bf, w_i8),
                         {}, "int8"),
    }


def measure(reps: int = 5, device: Optional[torch.device] = None) -> Dict[str, dict]:
    """Each body at the probe's geometry: one warm-up launch, then ``reps``
    launches between CUDA events (1 + reps launches of each public wrapper);
    the WMMA form it replaced (uncounted) and the library products the same
    way, the library in each w layout. Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("mxu_probe: needs a CUDA card; a CPU timing is not a tensor-core rate")
    device = device or torch.device("cuda", 0)
    x_bf, x_i8, w_bf, w_i8 = inputs(device)
    ops = 2 * x_bf.shape[0] * W * M * INNER
    res = {}
    for name, (kernel, wmma, libraries, kind) in bodies(x_bf, x_i8, w_bf, w_i8).items():
        kernel()
        torch.cuda.synchronize()
        ms = _events_ms(kernel, reps)
        wmma()
        torch.cuda.synchronize()
        wmma_ms = _events_ms(wmma, reps)
        by_layout = {}
        for layout, library in libraries.items():
            library()
            torch.cuda.synchronize()
            by_layout[layout] = _events_ms(library, reps)
        lib_ms = min(by_layout.values(), default=None)
        rate = ops / (ms * 1e-3)
        res[name] = {"ms": ms, "wmma_ms": wmma_ms, "ops": ops, "tera_ops_per_s": rate / 1e12,
                     "peak_share": rate / PEAK_OPS[kind], "kind": kind, "library_ms": lib_ms,
                     "library_ms_by_w_layout": by_layout,
                     "library_tera_ops_per_s": None if lib_ms is None else ops / lib_ms / 1e9}
    return res


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run(reps: int = 5) -> Dict[str, object]:
    """What ``python -m aiic_tpu_torch.probes.mxu_probe [reps]`` does: measure
    and print; returns the JSON line's object."""
    res = measure(reps)
    card = card_line()
    print(f"probe: ({R},{W})@({W},{M}) x {STEPS} steps x {INNER} products, reps={reps}; {card}")
    for name, r in res.items():
        unit = "TFLOP/s" if r["kind"] == "bf16" else "TOP/s"
        lib = "".join(f"; library, w {layout} {lib_ms:.3f} ms, {r['ops'] / lib_ms / 1e9:.1f} {unit}"
                      for layout, lib_ms in r["library_ms_by_w_layout"].items())
        print(f"{name:14s} {r['ms']:8.3f} ms {r['tera_ops_per_s']:7.1f} {unit} "
              f"({100 * r['peak_share']:.1f}% of the {r['kind']} peak); WMMA form "
              f"{r['wmma_ms']:.3f} ms{lib}", flush=True)
    out = {"card": card, "reps": reps, "bodies": res}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(int(argv[0]) if argv else 5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
