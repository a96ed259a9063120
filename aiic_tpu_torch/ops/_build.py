"""Build and load the Hopper kernels of ``aiic_tpu_torch/csrc``.

One shared library with a plain C interface, compiled by ``nvcc`` for
``sm_90a`` at first use and loaded with ``ctypes`` (no PyTorch headers, so
the build takes seconds). The library is keyed by a hash of the sources and
flags and lands in ``aiic_tpu_torch/_build/`` (listed in ``.gitignore``), so
a fresh checkout builds it from the repo's sources alone and an unchanged
tree reuses it.

No ``--use_fast_math``: the kernels must round like the plain versions
(IEEE division and square root, no flush to zero). ``-fmad=false`` keeps the
epilogues' ``a*b + c`` as two roundings, as PyTorch's separate ops do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

_LIB: Optional[ctypes.CDLL] = None
# Filled by load_library(): library path, build seconds (0 when reused),
# and the compiler's register/shared-memory report.
BUILD_INFO: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, ln_s, ln_b, w1_q, s1, b1, w2_q, s2, b2, out, hq, hs, y, yq, ys,
    # rows, W, M, eps, stream
    "aiic_int8_ln_mlp": [_P] * 15 + [_I, _I, _I, _F, _P],
    # x, ln_s, ln_b, wqkv_q, sqkv, bqkv, wo, bo, mask, out, hq, hs, qkv, attn,
    # B, S, W, H, eps, qconst, stream
    "aiic_int8_ln_qkv_attention": [_P] * 14 + [_I, _I, _I, _I, _F, _F, _P],
}


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
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cus)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    BUILD_INFO.update(path=str(so), seconds=seconds, log=log)
    _LIB = lib
    return lib
