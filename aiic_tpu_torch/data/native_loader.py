"""ctypes binding of the native host decoder (``native/decoder.cpp``) — the
port of ``aiic_tpu.data.native_loader``.

Threaded JPEG/PNG/WebP decode, PIL-exact bicubic resize and center crop into
uint8 HWC crops, or patch-major ones for the patch wire. The library is
built from ``native/decoder.cpp`` with the system C++ compiler at first use
into the port's own ``aiic_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source and flags; without a compiler or libjpeg the
Python fallback (PIL or OpenCV decode, the numpy resize) takes every blob.

The build is safe against concurrent first uses (several processes, such as
test workers, importing and calling at once): it compiles under an exclusive
file lock to a temporary name in the same directory and ``os.replace``s the
result into place, so a process only ever loads a finished library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "decoder.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
# Full build first (JPEG, PNG and WebP in one pool); where libpng or libwebp
# is missing, JPEG alone, as native/Makefile does.
LINKS = (["-ljpeg", "-lpng", "-lwebp"], ["-DAIIC_NO_EXTRA_CODECS", "-ljpeg"])

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False

_U8P = ctypes.POINTER(ctypes.c_uint8)
_IP = ctypes.POINTER(ctypes.c_int)


def build_library(build_dir=BUILD_DIR) -> Path:
    """Path of the decoder library in ``build_dir``, compiled first if no
    library of this source and these flags is there yet. Raises
    ``RuntimeError`` when the compiler fails on both link lines."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    build_dir = Path(build_dir)
    so = build_dir / f"libaiic_native_{digest}.so"
    if so.exists():
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / "libaiic_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if so.exists():  # another process finished it while this one waited
            return so
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cxx = os.environ.get("CXX", "g++")
        errors = []
        for link in LINKS:
            cmd = [cxx, *CXX_FLAGS, str(SOURCE), *link, "-o", str(tmp)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
            except (OSError, subprocess.SubprocessError) as e:
                errors.append(f"{' '.join(cmd)}: {e}")
                continue
            if proc.returncode == 0:
                os.replace(tmp, so)
                return so
            errors.append(f"{' '.join(cmd)}:\n{proc.stderr}")
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError("native decoder build failed:\n" + "\n".join(errors))


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        try:
            lib = ctypes.CDLL(str(build_library()))
        except (OSError, RuntimeError):
            _LIB_FAILED = True
            return None
        lib.aiic_preprocess_jpeg_batch_v3.restype = None
        lib.aiic_preprocess_jpeg_batch_v3.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int, ctypes.c_int, _U8P, _IP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.aiic_jpeg_dims.restype = ctypes.c_int
        lib.aiic_jpeg_dims.argtypes = [ctypes.c_char_p, ctypes.c_size_t, _IP, _IP]
        lib.aiic_decode_jpeg.restype = ctypes.c_int
        lib.aiic_decode_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_size_t, _U8P, _IP, _IP]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _build_and_load() is not None


def _to_patch_major(crop: np.ndarray, patch: int) -> np.ndarray:
    from aiic_tpu_torch.ops.preprocess import to_patch_major

    return to_patch_major(crop[None], patch)[0]


def preprocess_jpeg_batch(
    jpeg_blobs: Sequence[bytes],
    size: int = 224,
    num_threads: int = 0,
    fast: bool = False,
    patch: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Image bytes -> (uint8 pixels, ok mask (N,)).

    The native pool decodes JPEG, PNG and WebP (the name is kept from the
    JAX package). Pixels are HWC (N, size, size, 3), or patch-major
    (N, (size/p)^2, 3·p·p) when ``patch`` > 0, emitted by the decode pool.
    Failed decodes leave zero pixels with ok=False. ``fast=True`` decodes a
    JPEG at the smallest sufficient M/8 DCT scale before the bicubic
    (quality-approximate, not bit-identical); the resize target is still
    computed from the full source dimensions."""
    if patch and size % patch:
        raise ValueError(f"size {size} not divisible by patch {patch}")
    lib = _build_and_load()
    n = len(jpeg_blobs)
    shape = (n, (size // patch) ** 2, 3 * patch * patch) if patch else (n, size, size, 3)
    out = np.zeros(shape, dtype=np.uint8)
    if n == 0:
        return out, np.zeros((0,), bool)
    if lib is None:  # Python fallback: no native decoder
        ok = np.zeros((n,), bool)
        for i, blob in enumerate(jpeg_blobs):
            crop = _preprocess_one_python(blob, size, fast)
            if crop is not None:
                out[i] = _to_patch_major(crop, patch) if patch else crop
                ok[i] = True
        return out, ok
    bufs = [np.frombuffer(b, dtype=np.uint8) for b in jpeg_blobs]
    ptrs = (ctypes.c_char_p * n)(*[b.ctypes.data_as(ctypes.c_char_p) for b in bufs])
    lens = (ctypes.c_size_t * n)(*[len(b) for b in jpeg_blobs])
    status = (ctypes.c_int * n)()
    lib.aiic_preprocess_jpeg_batch_v3(ptrs, lens, n, size, out.ctypes.data_as(_U8P), status,
                                      num_threads, int(bool(fast)), patch)
    ok = np.asarray(list(status)) == 0
    return out, ok


def _preprocess_one_python(blob: bytes, size: int, fast: bool):
    """Pure-Python decode + PIL-exact resize + crop for one blob of any
    decodable format. Returns a uint8 (size, size, 3) crop or None.
    ``fast`` tries PIL's DCT-domain draft decode first (JPEG only)."""
    from aiic_tpu_torch.data.images import decode_image_bytes
    from aiic_tpu_torch.data.preprocess import (
        center_crop_bounds, resize_bicubic_numpy, resize_target,
    )

    full_dims = None
    arr = None
    if fast:
        arr, full_dims = _decode_draft(blob, size)
    if arr is None:
        arr = decode_image_bytes(blob)
    if arr is None:
        return None
    if full_dims is None:
        full_dims = (arr.shape[1], arr.shape[0])
    # the resize target from the full geometry, the bicubic from whatever
    # geometry the (possibly draft-scaled) decode gave
    nw, nh = resize_target(full_dims[0], full_dims[1], size)
    res = resize_bicubic_numpy(arr, nw, nh)
    top, left = center_crop_bounds(nw, nh, size)
    return res[max(top, 0): max(top, 0) + size,
               max(left, 0): max(left, 0) + size].astype(np.uint8)


def preprocess_any_batch(
    blobs: Sequence[bytes],
    size: int = 224,
    num_threads: int = 0,
    fast: bool = False,
    patch: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Bytes of any decodable format -> (uint8 crops, ok mask): the native
    threaded path first, then the per-blob Python fallback for whatever it
    rejected. ``patch`` > 0 emits the patch-major wire."""
    out, ok = preprocess_jpeg_batch(blobs, size=size, num_threads=num_threads, fast=fast,
                                    patch=patch)
    for i, blob in enumerate(blobs):
        if ok[i] or not blob:
            continue
        crop = _preprocess_one_python(blob, size, fast)
        if crop is not None:
            out[i] = _to_patch_major(crop, patch) if patch else crop
            ok[i] = True
    return out, ok


def _decode_draft(blob: bytes, size: int):
    """PIL's draft-mode JPEG decode (the DCT-domain M/8 scaled decode):
    (uint8 array at the draft geometry, (full_w, full_h)) or (None, None)."""
    import io

    from aiic_tpu_torch.data.preprocess import resize_target

    try:
        from PIL import Image

        img = Image.open(io.BytesIO(blob))
        full = img.size
        nw, nh = resize_target(full[0], full[1], size)
        img.draft("RGB", (nw, nh))
        return np.asarray(img.convert("RGB"), dtype=np.uint8), full
    except Exception:  # noqa: BLE001 - any undecodable blob is a load error
        return None, None


def decode_jpeg_raw(blob: bytes) -> Optional[np.ndarray]:
    """Decode-only: JPEG bytes -> raw uint8 (H, W, 3) at the source
    geometry, for the device-resize path (``ops.preprocess.
    device_preprocess_fixed``). PIL or OpenCV where the native library is
    unavailable; None for an undecodable blob."""
    if not blob:
        return None
    lib = _build_and_load()
    if lib is None:
        from aiic_tpu_torch.data.images import decode_image_bytes

        return decode_image_bytes(blob)
    buf = np.frombuffer(blob, dtype=np.uint8)
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    p = buf.ctypes.data_as(ctypes.c_char_p)
    if lib.aiic_jpeg_dims(p, len(blob), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    if w.value <= 0 or h.value <= 0:
        return None
    out = np.empty((h.value, w.value, 3), dtype=np.uint8)
    if lib.aiic_decode_jpeg(p, len(blob), out.ctypes.data_as(_U8P),
                            ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    return out


def preprocess_jpeg_files(
    paths: Sequence[str], size: int = 224, num_threads: int = 0,
    fast: bool = False, patch: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    blobs: List[bytes] = []
    for p in paths:
        try:
            with open(p, "rb") as f:
                blobs.append(f.read())
        except OSError:
            blobs.append(b"")
    return preprocess_jpeg_batch(blobs, size=size, num_threads=num_threads, fast=fast,
                                 patch=patch)
