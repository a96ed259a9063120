"""The port's data path against the JAX package: the image loaders, the
native decoder binding and its Python fallback, the streaming loaders and
the device resize.

Every comparison is exact (the same uint8 crops, ok masks and decoded
arrays; ``device_preprocess_fixed`` the same fp32 values): both packages run
the same decoder source, the same PIL or OpenCV calls and the same
separable-bicubic arithmetic. The native path is held against the JAX
package's native path and the Python fallback against its fallback; the two
paths of one package are held within one uint8 level of each other (PIL's
resample against libjpeg's decode and the C++ resample), as the JAX package's
own tests hold them.

The port builds its decoder library race-free: six processes building into
one empty directory at once must each load it. The port's stream ends for a
consumer slower than its producer (the JAX package's ``_Stream`` drops its
end marker on a full queue); those tests run under timeouts of their own.
"""

import io
import os
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from aiic_tpu.data import images as jax_images
from aiic_tpu.data import native_loader as jax_native
from aiic_tpu.data import pipeline as jax_pipeline
from aiic_tpu.ops import preprocess as jax_ops_pre
from aiic_tpu_torch.data import images, native_loader, pipeline
from aiic_tpu_torch.ops import preprocess as ops_pre

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32  # TINY_TEST's image size
PATCH = 8


def _image(seed, w, h):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _encoded(arr, fmt):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


BLOBS = {
    "jpeg": [_encoded(_image(1, 64, 48), "JPEG"), _encoded(_image(2, 40, 90), "JPEG")],
    "png": [_encoded(_image(3, 50, 50), "PNG"), _encoded(_image(4, 33, 70), "PNG")],
    "undecodable": [b"not an image at all", b"", _encoded(_image(5, 48, 48), "JPEG")[:40]],
}


@pytest.fixture
def both_native(monkeypatch):
    """Both packages on their native decoders. The JAX loader builds its
    library under native/ at first use; a process that saw it half-written
    marks it failed, so it is asked again here once it is whole."""
    if jax_native._LIB is None:
        monkeypatch.setattr(jax_native, "_LIB_FAILED", False)
    assert native_loader.native_available(), "the port's decoder did not build"
    assert jax_native.native_available(), "the JAX package's decoder did not build"


@pytest.fixture
def both_fallback(monkeypatch):
    """Both packages on their Python fallback (no native library)."""
    monkeypatch.setattr(native_loader, "_build_and_load", lambda: None)
    monkeypatch.setattr(jax_native, "_build_and_load", lambda: None)


@pytest.mark.parametrize("kind", ["jpeg", "png", "undecodable", "mixed"])
@pytest.mark.parametrize("patch", [0, PATCH], ids=["hwc", "patch"])
@pytest.mark.parametrize("path", ["native", "fallback"])
def test_preprocess_any_batch_matches_jax(request, kind, patch, path):
    request.getfixturevalue(f"both_{path}")
    blobs = (BLOBS["jpeg"] + BLOBS["png"] + BLOBS["undecodable"]) if kind == "mixed" else BLOBS[kind]
    got, ok = native_loader.preprocess_any_batch(blobs, SIZE, patch=patch)
    want, want_ok = jax_native.preprocess_any_batch(blobs, SIZE, patch=patch)
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_array_equal(got, want)
    assert ok.any() == (kind != "undecodable") and got.dtype == np.uint8
    if patch:
        assert got.shape == (len(blobs), (SIZE // PATCH) ** 2, 3 * PATCH * PATCH)


def test_native_and_fallback_within_one_level(monkeypatch):
    blobs = BLOBS["jpeg"] + BLOBS["png"]
    assert native_loader.native_available()
    native, ok = native_loader.preprocess_any_batch(blobs, SIZE)
    monkeypatch.setattr(native_loader, "_build_and_load", lambda: None)
    fallback, ok2 = native_loader.preprocess_any_batch(blobs, SIZE)
    assert ok.all() and ok2.all()
    assert np.abs(native.astype(int) - fallback.astype(int)).max() <= 1


def test_preprocess_jpeg_batch_rejects_bad_patch_and_empty():
    with pytest.raises(ValueError, match="not divisible"):
        native_loader.preprocess_jpeg_batch(BLOBS["jpeg"], SIZE, patch=5)
    out, ok = native_loader.preprocess_jpeg_batch([], SIZE)
    assert out.shape == (0, SIZE, SIZE, 3) and ok.shape == (0,)


@pytest.mark.parametrize("path", ["native", "fallback"])
def test_decode_jpeg_raw_matches_jax(request, path):
    request.getfixturevalue(f"both_{path}")
    for blob in BLOBS["jpeg"] + [b"", b"junk"]:
        got, want = native_loader.decode_jpeg_raw(blob), jax_native.decode_jpeg_raw(blob)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)


def test_native_build_is_race_free(tmp_path):
    """Six processes build the decoder into one empty directory at once;
    each loads the library and decodes a JPEG with it, one library is left
    and no temporary file."""
    out = tmp_path / "build"
    jpeg = tmp_path / "a.jpg"
    jpeg.write_bytes(BLOBS["jpeg"][0])
    code = (
        "import ctypes, sys\n"
        "import numpy as np\n"
        "from aiic_tpu_torch.data import native_loader as nl\n"
        f"so = nl.build_library({str(out)!r})\n"
        "lib = ctypes.CDLL(str(so))\n"
        "P = ctypes.POINTER(ctypes.c_int)\n"
        "lib.aiic_jpeg_dims.argtypes = [ctypes.c_char_p, ctypes.c_size_t, P, P]\n"
        "w, h = ctypes.c_int(0), ctypes.c_int(0)\n"
        f"blob = open({str(jpeg)!r}, 'rb').read()\n"
        "rc = lib.aiic_jpeg_dims(blob, len(blob), ctypes.byref(w), ctypes.byref(h))\n"
        "assert rc == 0 and (w.value, h.value) == (64, 48), (rc, w.value, h.value)\n"
        "print(so)\n")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert len({so.strip() for so, _ in outs}) == 1
    assert sorted(f.name for f in out.iterdir() if f.suffix != ".lock") == [
        os.path.basename(outs[0][0].strip())]


def test_decode_image_bytes_and_load_image_match_jax(tmp_path):
    for blob in BLOBS["jpeg"] + BLOBS["png"] + [b"junk"]:
        got, want = images.decode_image_bytes(blob), jax_images.decode_image_bytes(blob)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    path = tmp_path / "x.png"
    path.write_bytes(BLOBS["png"][0])
    np.testing.assert_array_equal(np.asarray(images.load_image(str(path))),
                                  np.asarray(jax_images.load_image(str(path))))
    assert images.load_image(str(tmp_path / "missing.jpg")) is None
    many = images.load_many([str(path), str(tmp_path / "missing.jpg")], max_workers=2)
    assert [p for p, _ in many] == [str(path), str(tmp_path / "missing.jpg")]
    assert many[1][1] is None and many[0][1].size == (50, 50)


def test_load_images_from_csv_matches_jax(tmp_path):
    csv = tmp_path / "photos.csv"
    csv.write_text("offer_id,seq,url\no1,0,a.jpg\no1,1,b.png\no2,0,c.jpg\n", encoding="utf-8")
    for cap in (None, 2):
        assert images.load_images_from_csv(str(csv), cap) == \
            jax_images.load_images_from_csv(str(csv), cap)
    assert images.load_images_from_csv(str(tmp_path / "missing.csv")) == []


def test_fetch_source_local_and_bytes(tmp_path):
    path = tmp_path / "a.jpg"
    path.write_bytes(BLOBS["jpeg"][0])
    for src in (str(path), BLOBS["png"][0], str(tmp_path / "missing.jpg")):
        assert pipeline.fetch_source(src) == jax_pipeline.fetch_source(src)
    assert pipeline.fetch_source(str(tmp_path / "missing.jpg")) == b""


def _files(tmp_path, kinds):
    paths = []
    for i, kind in enumerate(kinds):
        if kind == "missing":
            paths.append(str(tmp_path / f"missing{i}.jpg"))
            continue
        ext = "jpg" if kind == "jpeg" else "png"
        p = tmp_path / f"im{i}.{ext}"
        p.write_bytes(_encoded(_image(10 + i, 40 + 3 * i, 56 - 2 * i), kind.upper()))
        paths.append(str(p))
    return paths


def _drain(loader):
    return [(px.copy(), ok.copy(), rng) for px, ok, rng in loader]


def _stacked(batches):
    return (np.concatenate([px for px, _, _ in batches]),
            np.concatenate([ok for _, ok, _ in batches]))


# The JAX loaders run one batch only: their stream drops its end marker when
# its queue is full, so a JAX consumer behind two or more batches can wait
# forever. The port's loaders run several batches against that one.
@pytest.mark.parametrize("patch", [0, PATCH], ids=["hwc", "patch"])
def test_prefetching_loader_matches_jax(tmp_path, both_native, patch):
    paths = _files(tmp_path, ["jpeg"] * 5 + ["missing"])
    got = _drain(pipeline.PrefetchingLoader(paths, batch_size=2, size=SIZE, patch=patch))
    want = _drain(jax_pipeline.PrefetchingLoader(paths, batch_size=6, size=SIZE, patch=patch))
    assert [r for _, _, r in got] == [(0, 2), (2, 4), (4, 6)] and want[0][2] == (0, 6)
    (a, oa), (b, ob) = _stacked(got), _stacked(want)
    np.testing.assert_array_equal(oa, ob)
    np.testing.assert_array_equal(a, b)
    assert oa.tolist() == [True] * 5 + [False]  # the missing file


@pytest.mark.parametrize("patch", [0, PATCH], ids=["hwc", "patch"])
def test_byte_stream_loader_matches_jax(tmp_path, both_native, patch):
    sources = _files(tmp_path, ["jpeg", "png", "missing", "png"]) + [BLOBS["jpeg"][1], b"junk"]
    got = _drain(pipeline.ByteStreamLoader(sources, batch_size=2, size=SIZE, fetch_workers=2,
                                           patch=patch))
    want = _drain(jax_pipeline.ByteStreamLoader(sources, batch_size=6, size=SIZE,
                                                fetch_workers=2, patch=patch))
    assert [r for _, _, r in got] == [(0, 2), (2, 4), (4, 6)] and want[0][2] == (0, 6)
    (a, oa), (b, ob) = _stacked(got), _stacked(want)
    np.testing.assert_array_equal(oa, ob)
    np.testing.assert_array_equal(a, b)
    assert oa.tolist() == [True, True, False, True, True, False]


def _consume(stream, delay, box):
    for item in stream:
        box.append(item)
        time.sleep(delay)


def test_stream_slow_consumer_sees_the_end():
    """A producer that fills the queue and finishes while the consumer is
    still behind: the consumer gets every item, then the end."""
    def produce(q):
        for i in range(6):
            q.put(i)

    stream = pipeline._Stream(produce, depth=1)
    box: list = []
    t = threading.Thread(target=_consume, args=(stream, 0.05, box), daemon=True)
    t.start()
    t.join(timeout=20)
    assert not t.is_alive(), "the consumer never saw the end of the stream"
    assert box == list(range(6))


def test_stream_slow_consumer_gets_the_producer_error():
    def produce(q):
        q.put(0)
        q.put(1)
        raise RuntimeError("decode pool failed")

    stream = pipeline._Stream(produce, depth=1)
    box: list = []
    errors: list = []

    def run():
        try:
            _consume(stream, 0.05, box)
        except RuntimeError as e:
            errors.append(str(e))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=20)
    assert not t.is_alive()
    assert box == [0, 1] and errors == ["decode pool failed"]


def test_stream_close_releases_a_blocked_producer():
    """An abandoned stream: close() ends the producer's wait on the full
    queue, the end marker's included."""
    done = threading.Event()

    def produce(q):
        try:
            for i in range(100):
                q.put(i)
        finally:
            done.set()

    stream = pipeline._Stream(produce, depth=1)
    assert next(stream) == 0
    stream.close()
    assert done.wait(timeout=10)
    stream._thread.join(timeout=10)
    assert not stream._thread.is_alive()
    with pytest.raises(StopIteration):
        next(stream)


@pytest.mark.parametrize("geometry", [(48, 64), (100, 37), (480, 640)])
def test_device_preprocess_fixed_matches_jax(geometry):
    h, w = geometry
    x = np.random.default_rng(h * w).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    ky, kx, top, left = ops_pre.make_resize_mats(h, w, SIZE)
    rky, rkx, rtop, rleft = jax_ops_pre.make_resize_mats(h, w, SIZE)
    np.testing.assert_array_equal(ky, rky)
    np.testing.assert_array_equal(kx, rkx)
    assert (top, left) == (rtop, rleft)
    got = ops_pre.device_preprocess_fixed(torch.from_numpy(x), torch.from_numpy(ky),
                                          torch.from_numpy(kx), top, left, SIZE)
    want = jax_ops_pre.device_preprocess_fixed(jnp.asarray(x), jnp.asarray(ky), jnp.asarray(kx),
                                               top, left, SIZE)
    assert got.shape == (2, SIZE, SIZE, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bf16 = ops_pre.device_preprocess_fixed(torch.from_numpy(x), torch.from_numpy(ky),
                                           torch.from_numpy(kx), top, left, SIZE,
                                           dtype=torch.bfloat16)
    want16 = jax_ops_pre.device_preprocess_fixed(jnp.asarray(x), jnp.asarray(ky),
                                                 jnp.asarray(kx), top, left, SIZE,
                                                 dtype=jnp.bfloat16)
    np.testing.assert_array_equal(bf16.float().numpy(), np.asarray(want16).astype(np.float32))
