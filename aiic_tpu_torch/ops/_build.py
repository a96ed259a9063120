"""Build, load and launch the Hopper kernels of ``aiic_tpu_torch/csrc``.

One shared library with a plain C interface, compiled by ``nvcc`` for
``sm_90a`` at first use and loaded with ``ctypes`` (no PyTorch headers, so
the build takes seconds): one ``nvcc -c`` per source, all started together,
then one link. The library is keyed by a hash of the sources and
flags and lands in ``aiic_tpu_torch/_build/`` (listed in ``.gitignore``), so
a fresh checkout builds it from the repo's sources alone and an unchanged
tree reuses it.

No ``--use_fast_math``: the kernels must round like the plain versions
(IEEE division and square root, no flush to zero). ``-fmad=false`` keeps the
epilogues' ``a*b + c`` as two roundings, as PyTorch's separate ops do.

The launch side shared by every kernel wrapper lives here too: ``route``
(kernel for a CUDA tensor, plain version for a CPU tensor, an error for any
other device), ``ptr``/``f32_vector``/``check`` for the ctypes call, and
``counted``, which gives a wrapper its ``launches`` count and registers it
for ``launch_counts``/``reset_launch_counts``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

_LIB: Optional[ctypes.CDLL] = None
# Filled by load_library(): library path, build seconds (0 when reused),
# and the compiler's register/shared-memory report.
BUILD_INFO: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, ln_s, ln_b, w1_q, w1_t, s1, b1, w2_q, w2_t, s2, b2, out, hq, hs, y,
    # yq, ys, rows, W, M, eps, form, stream
    "aiic_int8_ln_mlp": [_P] * 17 + [_I, _I, _I, _F, _I, _P],
    # x, ln_s, ln_b, wqkv_q, wqkv_t, sqkv, bqkv, wo, bo, mask, out, hq, hs,
    # qkv, attn, B, S, W, H, eps, qconst, form, stream
    "aiic_int8_ln_qkv_attention": [_P] * 15 + [_I, _I, _I, _I, _F, _F, _I, _P],
    # x, ln_s, ln_b, w1_q, w1_t, s1, b1, w2_q, w2_t, s2, b2, out, hq, hs, y,
    # yq, ys, part, rows, W, M, n_chunks, eps, form, stream
    "aiic_int8_ln_mlp_chunked": [_P] * 18 + [_I, _I, _I, _I, _F, _I, _P],
    # x, ln_s, ln_b, wqkv_q, wqkv_t, sqkv, bqkv, qkv, hq, hs, rows, W, eps,
    # form, stream
    "aiic_int8_ln_qkv": [_P] * 10 + [_I, _I, _F, _I, _P],
    # a, w, rs, cs, b, x, out, rows, N, K, n_chunks, epi, form, stream
    "aiic_gemm_stage": [_P] * 7 + [_I] * 6 + [_P],
    # blocks (int[5]: int8, bf16, folded int8, bf16 bias, bf16 bias_gelu)
    "aiic_gemm_stage_occupancy": [_P],
    # x, 19 weights/K-major copies/vectors/mask, out, y1, hq, hs, qkv, attn, y,
    # yq, ys, part, B, S, W, H, M, n_chunks, eps, qconst, form, stream
    "aiic_int8_block": [_P] * 30 + [_I] * 6 + [_F, _F, _I, _P],
    # qkv, mask, out, B, S, W, H, qconst, fp32, scalar, stream
    "aiic_attention_qkv": [_P] * 3 + [_I, _I, _I, _I, _F, _I, _I, _P],
    # qkv_hm, mask, out, B, S, W, H, head_group, qconst, stream
    "aiic_attention_qkv_hg": [_P] * 3 + [_I] * 5 + [_F, _P],
    # blocks (int*)
    "aiic_attention_qkv_mma_occupancy": [_P],
    "aiic_attention_f32_occupancy": [_P],
    # x, ln_s, ln_b, wqkv, bqkv, wo, bo, mask, out, h, qkv, attn,
    # B, S, W, H, eps, qconst, form, stream
    "aiic_ln_qkv_attention": [_P] * 12 + [_I, _I, _I, _I, _F, _F, _I, _P],
    # x, ln_s, ln_b, w1, b1, w2, b2, out, h, y, rows, W, M, eps, form, stream
    "aiic_ln_mlp": [_P] * 10 + [_I, _I, _I, _F, _I, _P],
    # B, S, W, M, ro, rf, rp, fp32, backward -> bytes (a long long)
    "aiic_text_block_workspace": [_I] * 9,
    # x, mask, 18 weights/vectors/factors, y, ws, B, S, W, H, M, ro, rf, rp,
    # scaling, eps, qconst, fp32, form, stream
    "aiic_text_block_fwd": [_P] * 22 + [_I] * 8 + [_F] * 3 + [_I, _I, _P],
    # x, dy, mask, 18 weights, dx, six LoRA cotangents, ws, then as the forward
    "aiic_text_block_bwd": [_P] * 29 + [_I] * 8 + [_F] * 3 + [_I, _I, _P],
    # blocks (int[5]: the bf16 block's stage kernels)
    "aiic_text_block_occupancy": [_P],
    # blocks (int[5]: the tensor-core core forward and the rank-r kernels)
    "aiic_text_block_rank_occupancy": [_P],
    # A, B, out, part, rows, K, R, kind, trans, fp32, a_fp32, s, form, stream
    # (a rank-r product of the text block alone, for tests and timing)
    "aiic_rank_product": [_P] * 4 + [_I] * 7 + [_F, _I, _P],
    # A, B, C, M, N, K, trans, stream (the fp32 text block's backbone product
    # alone)
    "aiic_text_sgemm": [_P] * 3 + [_I] * 4 + [_P],
    # qkv, mask, out, B, S, W, H, qconst, form, stream (the bf16 text block's
    # core forward alone)
    "aiic_block_core_fwd": [_P] * 3 + [_I] * 4 + [_F, _I, _P],
    # B, S, W, M, ro, rf, rp, n_chunks, backward -> bytes (a long long)
    "aiic_text_block_int8_workspace": [_I] * 9,
    # x, mask, 21 weights/scales/vectors/factors, wqkv_t, w1_t, w2_t (the
    # K-major copies), y, ws, B, S, W, H, M, ro, rf, rp, scaling, eps,
    # qconst, form, stream
    "aiic_text_block_int8_fwd": [_P] * 28 + [_I] * 8 + [_F] * 3 + [_I, _P],
    # x, dy, mask, 21 weights, 3 K-major copies, dx, six LoRA cotangents, ws,
    # then as the forward with n_chunks after rp
    "aiic_text_block_int8_bwd": [_P] * 35 + [_I] * 9 + [_F] * 3 + [_I, _P],
    # blocks (int[7]: the int8 block's stage kernels and core passes)
    "aiic_text_block_int8_occupancy": [_P],
    # A, B, out, M, N, K, ksplit, form, stream (the int8 A @ B^T alone, for
    # tests)
    "aiic_int8_matmul_t": [_P] * 3 + [_I] * 5 + [_P],
    # q, k, v, mask, out, B, S, H, D, qconst, fp32, scalar, stream
    "aiic_attention_bshd": [_P] * 5 + [_I] * 4 + [_F, _I, _I, _P],
    # qkv, mask, g, dqkv, ws, B, S, W, H, qconst, fp32, form, stream
    "aiic_attention_qkv_bwd": [_P] * 5 + [_I] * 4 + [_F, _I, _I, _P],
    # blocks (int[2]: pass 1, pass 2)
    "aiic_attention_qkv_bwd_mma_occupancy": [_P],
    "aiic_attention_qkv_bwd_tiled_occupancy": [_P],
    # x, w, out, rows, W, M, inner, body, stream
    "aiic_mxu_probe": [_P] * 3 + [_I] * 5 + [_P],
    # x, w (bf16) or w^T (int8), out, xq, scales, rows, W, M, inner, body, stream
    "aiic_mxu_probe_wgmma": [_P] * 5 + [_I] * 5 + [_P],
    # blocks (int[3]: bf16, i8, i8_quant)
    "aiic_mxu_probe_wgmma_occupancy": [_P],
    # variant, x, ln_s, ln_b, wqkv_q, sqkv, bqkv, wo_q, so, wo, bo, out, hq, hs,
    # amax, qkv, attn, aq, as, B, S, W, H, eps, qconst, stream
    "aiic_attn_variant": [_I] + [_P] * 18 + [_I] * 4 + [_F, _F, _P],
    # variant, x, ln_s, ln_b, w1_q, s1, b1, w2_q, s2, b2, w1, w2, out, hq, hb,
    # hs, y, yb, yq, ys, rows, W, M, eps, stream
    "aiic_mlp_variant": [_I] + [_P] * 19 + [_I] * 3 + [_F, _P],
}
_RESTYPES = {"aiic_text_block_workspace": ctypes.c_longlong,
             "aiic_text_block_int8_workspace": ctypes.c_longlong}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the Hopper kernels are built with the CUDA toolkit")
    return path


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def source_digest() -> str:
    cus, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cus + hdrs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    global _LIB
    if _LIB is not None:
        return _LIB
    cus, _ = _sources()
    if not cus:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    so = BUILD_DIR / f"libaiic_kernels_{source_digest()}.so"
    seconds, log = 0.0, ""
    done: Dict[str, float] = {}  # seconds each source took, for the build report
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        objs = [BUILD_DIR / f"{cu.stem}.{tag}.o" for cu in cus]
        t0 = time.perf_counter()
        outs = [o.with_suffix(".log") for o in objs]
        procs = []
        for cu, o, out in zip(cus, objs, outs):
            with open(out, "w") as f:
                procs.append(subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(cu)],
                                              stdout=f, stderr=subprocess.STDOUT))
        while len(done) < len(procs):
            for cu, proc in zip(cus, procs):
                if cu.name not in done and proc.poll() is not None:
                    done[cu.name] = round(time.perf_counter() - t0, 2)
            time.sleep(0.05)
        log = "".join(out.read_text() for out in outs)
        for out in outs:
            out.unlink()
        failed = [cu.name for cu, p in zip(cus, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = so.with_suffix(f".{tag}")
        link = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        for o in objs:
            o.unlink()
        seconds = time.perf_counter() - t0
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    BUILD_INFO.update(path=str(so), seconds=seconds, per_source_s=done, log=log)
    _LIB = lib
    return lib


# ---------------------------------------------------------------------------
# Launch helpers shared by the kernel wrappers
# ---------------------------------------------------------------------------

_COUNTED: Dict[str, Callable] = {}


def counted(fn: Callable) -> Callable:
    """Give a kernel wrapper a ``launches`` count (incremented by the wrapper
    where it launches its kernel, and nowhere else) and register it."""
    fn.launches = 0
    _COUNTED[fn.__name__] = fn
    return fn


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0


# The forms of the kernels redesigned on the wgmma GEMM stage (rows 1-5 and
# 10-14 and the stage alone), as their C entries' ``form``: the route, and
# the first (WMMA) design, kept for timing and the side-by-side check.
FORMS = {"wgmma": 0, "wmma": 1}


def form_code(name: str, form: str) -> int:
    """The C entries' code of ``form``; ValueError on any other, before
    anything is built or launched."""
    if form not in FORMS:
        raise ValueError(f"{name}: no {form!r} form (forms {list(FORMS)})")
    return FORMS[form]


def route(name: str, x: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version (CPU)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"{name}: no kernel for device {x.device}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def f32_vector(t: torch.Tensor, n: int, device: torch.device) -> torch.Tensor:
    """A length-n fp32 vector on ``device`` (raises on any other size)."""
    return t.reshape(n).to(device=device, dtype=torch.float32).contiguous()


def bf16_activation(name: str, x: torch.Tensor) -> None:
    """The half-block kernels take bf16 (B, S, W) activations only."""
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise TypeError(f"{name}: the Hopper kernel takes bf16 (B, S, W) activations, "
                        f"got {x.dtype} {tuple(x.shape)}")


def weight(name: str, w: torch.Tensor, shape, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """A contiguous weight of ``shape`` cast to ``dtype``; raises if it lies
    on another device or has another shape (the kernel reads raw pointers)."""
    if w.device != device or tuple(w.shape) != tuple(shape):
        raise ValueError(f"{name}: weight must be {tuple(shape)} on {device}, "
                         f"got {tuple(w.shape)} on {w.device}")
    return w.to(dtype).contiguous()


def mask_arg(mask: Optional[torch.Tensor], seq: int, device: torch.device):
    """The additive (S, S) mask as a contiguous fp32 tensor, or None."""
    if mask is None:
        return None
    mask = mask.to(device=device, dtype=torch.float32).contiguous()
    if mask.shape != (seq, seq):
        raise ValueError(f"mask must be ({seq}, {seq}), got {tuple(mask.shape)}")
    return mask


def check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
