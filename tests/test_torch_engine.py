"""The port's classify program and InteriorAnalyzer against the JAX engine.

Both engines get the same weights and the fixture vocabulary of
tests/test_engine.py, in two serving configurations (the JAX kernels in
interpret mode): int8 serving (bf16, int8, patch wire) and the worker's
default (bf16 without int8 weights, HWC uint8 wire normalized on the
device). Verdicts, categories and attribute names
must be identical; confidences agree within 1e-3. Top-k ties may be
ordered differently by torch.topk and lax.top_k, so indices are compared
only where the values differ.

The int8 engine with ``use_lora`` folds a rank-4 c_fc/c_proj adapter (a
saved ``.pth``, or its loaded dict) before quantizing, in both packages; it
is held to the same bars as the int8 engine.

The constructor's options shared with the JAX engine default as JAX's
(fp32, no int8 weights, HWC wire, ``attn_impl="auto"``): the signatures are
compared, and the two default engines (fp32, ``"auto"`` is ``"xla"`` on the
CPU in both) give the same results, features to a cosine of 0.99999 and
confidences within 1e-4 (fp32 sums in another order, amplified by the 100x
softmax temperatures).

The JAX programs are compiled with ``xla_allow_excess_precision`` off. By
default XLA on the CPU may keep a bf16 intermediate in fp32, while the port
(like the Hopper kernels) rounds each bf16 result. With 100x softmax
temperatures at the tiny test width, that alone moves confidences by ~1e-2;
with every bf16 rounding kept, the two engines agree to ~1e-6.

The serving surface (fp32 engines on the same weights; features and
confidences within 1e-5, verdicts, categories and top-k names equal): the
dispatch/fetch pair against ``classify_pixels`` and JAX's, ``warmup``'s
buckets, a ``text_cache`` npz written by either package and read by the
other, ``analyze_images_batch`` over local JPEGs, PNGs and missing paths
(the port in several stream batches, the JAX engine in one: its stream can
lose its end behind two or more), with the filter on and off and with
``device_resize``, the single-image helpers, the stage timings, the
refused mesh, and the hermetic-tokenizer warning on loaded weights.
"""

import dataclasses
import functools
import inspect
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiic_tpu.engine import InteriorAnalyzer as JaxAnalyzer
from aiic_tpu.engine import programs as jax_programs
from aiic_tpu.models.config import TINY_TEST as JAX_TINY
from aiic_tpu.models.init import flatten_params, init_clip_params
from aiic_tpu.ops.preprocess import to_patch_major
from aiic_tpu_torch.engine import programs
from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer
from aiic_tpu_torch.engine.detector import INTERIOR_COUNT
from aiic_tpu_torch.models.config import TINY_TEST
from aiic_tpu_torch.models.init import params_from_numpy
from aiic_tpu_torch.ops import _build, quant

torch.set_num_threads(2)

TRAINING = [
    {"image_path": "x.jpg", "style": "nowoczesny",
     "characteristics": ["czyste linie", "przestronne"], "materials": ["drewno"],
     "colors": ["biały", "szary"], "room_type": "kuchnia"},
    {"image_path": "y.jpg", "style": "klasyczny", "characteristics": ["eleganckie"],
     "materials": ["marmur"], "colors": ["beżowy"], "room_type": "salon"},
]


@pytest.fixture(scope="module")
def engines():
    jp = init_clip_params(jax.random.PRNGKey(0), JAX_TINY)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # real-weights-with-hermetic-tokenizer notice
        ref = JaxAnalyzer(jp, JAX_TINY, training_data=TRAINING, dtype=jnp.bfloat16,
                          quantize=True, attn_impl="pallas", wire_format="patch", max_batch=4)
    _build.reset_launch_counts()
    ours = InteriorAnalyzer(params_from_numpy(flatten_params(jp)), TINY_TEST,
                            training_data=TRAINING, dtype=torch.bfloat16, quantize=True,
                            wire_format="patch", attn_impl="pallas", max_batch=4, device="cpu")
    return ref, ours


EXACT_BF16 = {"xla_allow_excess_precision": False}


def _jax_classify(ref, pixels):
    """The JAX engine's classify program with every bf16 rounding kept."""
    fn = jax.jit(functools.partial(
        jax_programs.classify_batch, config=JAX_TINY, interior_count=INTERIOR_COUNT,
        dtype=jnp.bfloat16, attn_impl="pallas"), compiler_options=EXACT_BF16)
    out = fn(ref.params, jnp.asarray(pixels), ref.det_text, ref.cat_text, ref.cat_mask)
    return {k: np.asarray(v) for k, v in out.items()}


def _pixels(n, seed):
    s = TINY_TEST.image_size
    return np.random.default_rng(seed).integers(0, 256, (n, s, s, 3), dtype=np.uint8)


def _topk_close(vals, idx, rvals, ridx, atol):
    np.testing.assert_allclose(vals, rvals, atol=atol)
    differ = np.abs(np.diff(rvals, axis=-1)) > atol  # neighbours not tied
    distinct = np.concatenate([differ[..., :1], differ[..., 1:] & differ[..., :-1], differ[..., -1:]], -1)
    np.testing.assert_array_equal(idx[distinct], ridx[distinct])


def test_engine_vocabulary_and_text_features(engines):
    ref, ours = engines
    assert ours.all_categories == ref.all_categories
    assert ours.category_names == ref.category_names
    np.testing.assert_array_equal(ours.cat_mask.numpy(), np.asarray(ref.cat_mask))
    for a, b in ((ours.det_text, ref.det_text), (ours.cat_text, ref.cat_text)):
        a = a.numpy().reshape(-1, TINY_TEST.embed_dim)
        b = np.asarray(b).reshape(a.shape)
        live = np.linalg.norm(b, axis=-1) > 0
        cos = (a[live] * b[live]).sum(-1) / (np.linalg.norm(a[live], axis=-1) * np.linalg.norm(b[live], axis=-1))
        assert cos.min() >= 0.9999
    # the wrappers took the plain versions on the CPU: nothing was launched
    assert quant.int8_ln_mlp.launches == 0 and quant.int8_ln_qkv_attention.launches == 0


def test_classify_batch_matches_jax(engines):
    ref, ours = engines
    pm = to_patch_major(_pixels(4, seed=7), TINY_TEST.patch_size)
    jout = _jax_classify(ref, pm)
    tout = programs.classify_batch(
        ours.params, torch.from_numpy(pm), torch.from_numpy(np.array(ref.det_text)),
        torch.from_numpy(np.array(ref.cat_text)), torch.from_numpy(np.array(ref.cat_mask)),
        config=TINY_TEST, interior_count=INTERIOR_COUNT, dtype=torch.bfloat16)
    assert set(tout) == set(jout)
    f, rf = tout["features"].numpy(), jout["features"]
    assert ((f * rf).sum(-1)).min() >= 0.9999  # both L2-normalized
    for k in ("top_conf", "interior_mass", "non_interior_mass"):
        np.testing.assert_allclose(tout[k].numpy(), jout[k], atol=1e-3)
    _topk_close(tout["topk_vals"].numpy(), tout["topk_idx"].numpy(),
                jout["topk_vals"], jout["topk_idx"], 1e-3)


def _jax_results(ref, px, threshold=0.3, filter_interiors=True):
    """The JAX engine's analyze_images_batch assembly, on in-memory pixels
    (one bucket: the JAX engine's chunking is that of the port's)."""
    wire = to_patch_major(px, TINY_TEST.patch_size) if ref.wire_format == "patch" else px
    res = _jax_classify(ref, wire)
    out = []
    from aiic_tpu.engine.detector import DETECTOR_CATEGORIES

    for row in range(len(px)):
        conf = float(res["interior_mass"][row])
        is_int = (res["interior_mass"][row] > res["non_interior_mass"][row]
                  and float(res["top_conf"][row]) > threshold)
        if filter_interiors and not is_int:
            out.append({"is_interior": False, "interior_confidence": conf,
                        "detected_category": DETECTOR_CATEGORIES[int(res["top_idx"][row])],
                        "analysis": {}})
        else:
            out.append({"is_interior": True, "interior_confidence": conf if filter_interiors else 1.0,
                        "detected_category": "interior",
                        "analysis": ref._assemble_analysis(res, row)})
    return out


def _check_results(got, want):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g["is_interior"] == w["is_interior"]
        assert g["detected_category"] == w["detected_category"]
        assert abs(g["interior_confidence"] - w["interior_confidence"]) <= 1e-3
        assert set(g["analysis"]) == set(w["analysis"])
        for cat, top in g["analysis"].items():
            wtop = w["analysis"][cat]
            assert [a for a, _ in top] == [a for a, _ in wtop]
            np.testing.assert_allclose([v for _, v in top], [v for _, v in wtop], atol=1e-3)
        if g["is_interior"]:
            assert g["reason"] == "Success - interior image analyzed"
        else:
            assert g["reason"].startswith(f"Nie wnętrze: {g['detected_category']} (confidence: ")


@pytest.fixture(scope="module")
def lora_pth(tmp_path_factory):
    """A rank-4 c_fc/c_proj adapter with nonzero B at TINY_TEST, in the
    reference layout, big enough to move the int8 weights."""
    from aiic_tpu_torch.adapters import save_lora_pth

    rng = np.random.default_rng(21)
    t = TINY_TEST.text
    f = lambda *shape: torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32))  # noqa: E731
    path = str(tmp_path_factory.mktemp("lora") / "adapter.pth")
    save_lora_pth({"c_fc": {"A": f(t.layers, t.width, 4), "B": f(t.layers, 4, t.mlp_dim)},
                   "c_proj": {"A": f(t.layers, t.mlp_dim, 4), "B": f(t.layers, 4, t.width)}}, path)
    return path


@pytest.mark.parametrize("source", ["pth", "dict"])
def test_int8_use_lora_engine_matches_jax(engines, lora_pth, source):
    """``use_lora`` with the adapter as a path and as a loaded state dict:
    text features, verdicts and top-5 as the JAX engine with the same
    adapter; the fold happens before the quantization, so the int8 weights
    and the text features move."""
    jax_engine, plain = engines
    jp = init_clip_params(jax.random.PRNGKey(0), JAX_TINY)
    weights = torch.load(lora_pth, map_location="cpu", weights_only=True)
    src = lora_pth if source == "pth" else weights
    kw = dict(training_data=TRAINING, dtype=jnp.bfloat16, quantize=True, attn_impl="pallas",
              wire_format="patch", max_batch=4, use_lora=True, lora_weights_path=src)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = JaxAnalyzer(jp, JAX_TINY, **kw)
    ours = InteriorAnalyzer(params_from_numpy(flatten_params(jp)), TINY_TEST,
                            **dict(kw, dtype=torch.bfloat16), device="cpu")
    assert ours.use_lora and ref.use_lora
    for key in ("w1_q", "w2_q"):
        folded = ours.params["text"]["blocks"]["mlp_q"][key]
        assert not torch.equal(folded, plain.params["text"]["blocks"]["mlp_q"][key]), key
        np.testing.assert_array_equal(folded.numpy(),
                                      np.asarray(ref.params["text"]["blocks"]["mlp_q"][key]))
    assert torch.equal(ours.params["text"]["blocks"]["attn_q"]["wqkv_q"],
                       plain.params["text"]["blocks"]["attn_q"]["wqkv_q"])  # no out_proj adapter
    assert not torch.equal(ours.det_text, plain.det_text)
    a = ours.det_text.numpy()
    b = np.asarray(ref.det_text)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert cos.min() >= 0.9999
    px = _pixels(5, seed=22)
    _check_results(ours.analyze_pixels(px), _jax_results(ref, px))


@pytest.mark.parametrize("filter_interiors", [True, False], ids=["filter", "nofilter"])
def test_analyze_pixels_matches_jax_engine(engines, filter_interiors):
    ref, ours = engines
    px = _pixels(5, seed=8)  # max_batch=4: a full chunk and a padded one
    _check_results(ours.analyze_pixels(px, filter_interiors=filter_interiors),
                   _jax_results(ref, px, 0.3, filter_interiors))


@pytest.fixture(scope="module")
def bf16_engines():
    """The worker's default: bf16, no int8 weights, HWC uint8 wire."""
    jp = init_clip_params(jax.random.PRNGKey(0), JAX_TINY)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = JaxAnalyzer(jp, JAX_TINY, training_data=TRAINING, dtype=jnp.bfloat16,
                          quantize=False, attn_impl="pallas", wire_format="hwc", max_batch=4)
    ours = InteriorAnalyzer(params_from_numpy(flatten_params(jp)), TINY_TEST,
                            training_data=TRAINING, dtype=torch.bfloat16, quantize=False,
                            wire_format="hwc", attn_impl="pallas", max_batch=4, device="cpu")
    return ref, ours


def test_bf16_unquantized_text_features_match_jax(bf16_engines):
    ref, ours = bf16_engines
    assert not ours.quantized and "attn_q" not in ours.params["text"]["blocks"]
    for a, b in ((ours.det_text, ref.det_text), (ours.cat_text, ref.cat_text)):
        a = a.numpy().reshape(-1, TINY_TEST.embed_dim)
        b = np.asarray(b).reshape(a.shape)
        live = np.linalg.norm(b, axis=-1) > 0
        cos = (a[live] * b[live]).sum(-1) / (np.linalg.norm(a[live], axis=-1) * np.linalg.norm(b[live], axis=-1))
        assert cos.min() >= 0.9999


def test_bf16_unquantized_classify_batch_matches_jax(bf16_engines):
    ref, ours = bf16_engines
    px = _pixels(4, seed=17)  # uint8 HWC: normalized on the device by both
    jout = _jax_classify(ref, px)
    tout = programs.classify_batch(
        ours.params, torch.from_numpy(px), torch.from_numpy(np.array(ref.det_text)),
        torch.from_numpy(np.array(ref.cat_text)), torch.from_numpy(np.array(ref.cat_mask)),
        config=TINY_TEST, interior_count=INTERIOR_COUNT, dtype=torch.bfloat16)
    assert ((tout["features"].numpy() * jout["features"]).sum(-1)).min() >= 0.9999
    for k in ("top_conf", "interior_mass", "non_interior_mass"):
        np.testing.assert_allclose(tout[k].numpy(), jout[k], atol=1e-3)
    _topk_close(tout["topk_vals"].numpy(), tout["topk_idx"].numpy(),
                jout["topk_vals"], jout["topk_idx"], 1e-3)


@pytest.mark.parametrize("filter_interiors", [True, False], ids=["filter", "nofilter"])
def test_bf16_unquantized_analyze_pixels_matches_jax_engine(bf16_engines, filter_interiors):
    ref, ours = bf16_engines
    px = _pixels(5, seed=18)
    _check_results(ours.analyze_pixels(px, filter_interiors=filter_interiors),
                   _jax_results(ref, px, 0.3, filter_interiors))


def test_detector_and_topk_programs_match_jax():
    rng = np.random.default_rng(9)
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)  # noqa: E731
    feats = unit(rng.standard_normal((6, 16))).astype(np.float32)
    det = unit(rng.standard_normal((40, 16))).astype(np.float32)
    cat = unit(rng.standard_normal((3, 7, 16))).astype(np.float32)
    mask = np.zeros((3, 7), bool)
    mask[0], mask[1, :3], mask[2, :1] = True, True, True
    cat[~mask] = 0.0
    d = programs.detect_logits(torch.from_numpy(feats), torch.from_numpy(det), INTERIOR_COUNT)
    rd = jax_programs.detect_logits(jnp.asarray(feats), jnp.asarray(det), INTERIOR_COUNT)
    for k in rd:
        np.testing.assert_allclose(d[k].numpy(), np.asarray(rd[k]), rtol=1e-5, atol=1e-6)
    vals, idx = programs.analyze_topk(torch.from_numpy(feats), torch.from_numpy(cat),
                                      torch.from_numpy(mask), k=5)
    rvals, ridx = jax_programs.analyze_topk(jnp.asarray(feats), jnp.asarray(cat), jnp.asarray(mask), k=5)
    _topk_close(vals.numpy(), idx.numpy(), np.asarray(rvals), np.asarray(ridx), 1e-5)
    assert (vals.numpy()[:, 1, 3:] == 0).all() and (vals.numpy()[:, 2, 1:] == 0).all()


def _default_name(value):
    """A default as comparable across the packages: dtypes by name, the
    config dataclasses (one per package) by their fields."""
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    if isinstance(value, torch.dtype):
        return str(value).removeprefix("torch.")
    if isinstance(value, type):  # jnp.float32 and the like
        return np.dtype(getattr(value, "dtype", value)).name
    return value


def test_analyzer_shared_defaults_equal_jax():
    ours = inspect.signature(InteriorAnalyzer.__init__).parameters
    ref = inspect.signature(JaxAnalyzer.__init__).parameters
    shared = (set(ours) & set(ref)) - {"self"}
    assert {"dtype", "quantize", "wire_format", "attn_impl", "max_batch", "seed",
            "dataset_json"} <= shared
    for name in sorted(shared):
        assert _default_name(ours[name].default) == _default_name(ref[name].default), name
    assert "device" in ours and "device" not in ref  # the port's own option


def test_default_engines_match_jax():
    """``InteriorAnalyzer(params, config, training_data=...)`` builds the same
    engine in both packages: the fp32 one on the HWC wire."""
    jp = init_clip_params(jax.random.PRNGKey(2), JAX_TINY)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = JaxAnalyzer(jp, JAX_TINY, training_data=TRAINING, max_batch=4)
    ours = InteriorAnalyzer(params_from_numpy(flatten_params(jp)), TINY_TEST,
                            training_data=TRAINING, max_batch=4, device="cpu")
    assert (ours.dtype, ours.quantized, ours.wire_format, ours.attn_impl) == (
        torch.float32, False, "hwc", "auto")
    assert ref.dtype == jnp.float32 and ref.wire_format == "hwc"
    px = _pixels(5, seed=4)
    got, want = ours.classify_pixels(px), {k: np.asarray(v) for k, v in ref.classify_pixels(px).items()}
    assert set(got) == set(want)
    assert ((got["features"] * want["features"]).sum(-1)).min() >= 0.99999
    for k in ("top_conf", "interior_mass", "non_interior_mass"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4)
    _topk_close(got["topk_vals"], got["topk_idx"], want["topk_vals"], want["topk_idx"], 1e-4)


def test_dataset_json_vocabulary_matches_jax(tmp_path):
    """With no ``training_data``, both engines build their vocabulary from
    ``dataset_json`` (``{"training_data": [...]}``) and give the same
    categories and results."""
    path = tmp_path / "dataset.json"
    path.write_text(json.dumps({"training_data": TRAINING}, ensure_ascii=False),
                    encoding="utf-8")
    jp = init_clip_params(jax.random.PRNGKey(3), JAX_TINY)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = JaxAnalyzer(jp, JAX_TINY, dataset_json=str(path), max_batch=4)
    ours = InteriorAnalyzer(params_from_numpy(flatten_params(jp)), TINY_TEST,
                            dataset_json=str(path), max_batch=4, device="cpu")
    assert ours.category_names == ref.category_names
    assert ours.category_names == ["styles", "characteristics", "materials", "colors",
                                   "room_types"]
    assert ours.training_data == ref.training_data == TRAINING
    px = _pixels(3, seed=5)
    got, want = ours.classify_pixels(px), {k: np.asarray(v) for k, v in ref.classify_pixels(px).items()}
    assert set(got) == set(want)
    assert ((got["features"] * want["features"]).sum(-1)).min() >= 0.99999
    for k in ("top_conf", "interior_mass", "non_interior_mass"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4)
    _topk_close(got["topk_vals"], got["topk_idx"], want["topk_vals"], want["topk_idx"], 1e-4)


def test_dataset_json_missing_gives_empty_vocabulary(tmp_path):
    missing = str(tmp_path / "absent.json")
    jp = init_clip_params(jax.random.PRNGKey(3), JAX_TINY)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = JaxAnalyzer(jp, JAX_TINY, dataset_json=missing, max_batch=4)
    ours = InteriorAnalyzer(params_from_numpy(flatten_params(jp)), TINY_TEST,
                            dataset_json=missing, max_batch=4, device="cpu")
    assert ours.training_data == ref.training_data == []
    assert ours.category_names == ref.category_names == []


# ---------------------------------------------------------------------------
# The serving surface: dispatch/fetch, warmup, the text cache, file and URL
# ingest, the single-image helpers, the stage timings. fp32 engines on the
# same weights (attn_impl "auto" is "xla" on the CPU in both packages):
# features and confidences within 1e-5, verdicts, categories and top-k
# names equal.
# ---------------------------------------------------------------------------

TOL = 1e-5


@pytest.fixture(scope="module")
def fp32_engines():
    from aiic_tpu.serve.metrics import Metrics as JaxMetrics
    from aiic_tpu_torch.serve.metrics import Metrics

    jp = init_clip_params(jax.random.PRNGKey(0), JAX_TINY)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = JaxAnalyzer(jp, JAX_TINY, training_data=TRAINING, max_batch=4,
                          metrics=JaxMetrics())
        ours = InteriorAnalyzer(params_from_numpy(flatten_params(jp)), TINY_TEST,
                                training_data=TRAINING, max_batch=4, device="cpu",
                                metrics=Metrics())
    return ref, ours


def _close_results(got, want):
    assert set(got) == set(want)
    for k in got:
        if got[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0)
        else:
            np.testing.assert_array_equal(got[k], want[k])


def _same_result(g, w):
    """One five-key result dict against the JAX engine's."""
    assert set(g) == set(w)
    for k in ("is_interior", "detected_category", "reason"):
        assert g[k] == w[k], k
    assert abs(g["interior_confidence"] - w["interior_confidence"]) <= TOL
    assert set(g["analysis"]) == set(w["analysis"])
    for cat, top in g["analysis"].items():
        assert [a for a, _ in top] == [a for a, _ in w["analysis"][cat]]
        np.testing.assert_allclose([v for _, v in top], [v for _, v in w["analysis"][cat]],
                                   atol=TOL, rtol=0)


def test_dispatch_fetch_pair_matches_classify_and_jax(fp32_engines):
    ref, ours = fp32_engines
    px = _pixels(6, seed=31)  # max_batch 4: two chunks, the second padded
    pending = ours.dispatch_pixels(px)
    assert len(pending) == 2 and [v for _, v in pending] == [4, 2]
    got = ours.fetch_results(pending)
    same = ours.classify_pixels(px)
    for k in got:
        np.testing.assert_array_equal(got[k], same[k])
    want = {k: np.asarray(v) for k, v in ref.fetch_results(ref.dispatch_pixels(px)).items()}
    _close_results(got, want)
    assert got["features"].shape == (6, TINY_TEST.embed_dim)
    cap2 = ours.classify_pixels(px, max_batch=2)
    _close_results(cap2, want)
    assert ours.max_batch == 4  # the per-call cap leaves the engine's alone


@pytest.mark.parametrize("sizes", [None, [1, 3, 5, 8, 16], [2, 2, 4]], ids=["default", "mixed",
                                                                             "repeated"])
def test_warmup_runs_the_buckets_jax_runs(fp32_engines, sizes, monkeypatch):
    ref, ours = fp32_engines
    calls = {"ours": [], "ref": []}
    for name, eng in (("ours", ours), ("ref", ref)):
        monkeypatch.setattr(eng, "classify_pixels",
                            lambda px, max_batch=None, _l=calls[name]: _l.append(
                                (px.shape, px.dtype.name, max_batch)))
        eng.warmup(sizes)
    assert calls["ours"] == calls["ref"] and calls["ours"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_text_cache_is_read_across_packages(tmp_path, writer):
    """An npz written by either engine is read by the other: the reader's
    text features are the file's, bit for bit, and its results those of the
    writer within 1e-5."""
    jp = init_clip_params(jax.random.PRNGKey(5), JAX_TINY)
    cache = str(tmp_path / "text.npz")
    kw = dict(training_data=TRAINING, max_batch=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if writer == "jax":
            first = JaxAnalyzer(jp, JAX_TINY, text_cache=cache, **kw)
        else:
            first = InteriorAnalyzer(params_from_numpy(flatten_params(jp)), TINY_TEST,
                                     text_cache=cache, device="cpu", **kw)
        with np.load(cache) as blob:
            saved = {k: blob[k] for k in blob.files}
        assert sorted(saved) == ["cat_mask", "cat_text", "det_text"]
        assert {k: v.dtype.name for k, v in saved.items()} == {
            "det_text": "float32", "cat_text": "float32", "cat_mask": "bool"}
        # the reader's own text tower would differ from the file in the last
        # bits: equal bits say the file was read
        if writer == "jax":
            second = InteriorAnalyzer(params_from_numpy(flatten_params(jp)), TINY_TEST,
                                      text_cache=cache, device="cpu", **kw)
            texts = {k: getattr(second, k).numpy() for k in saved}
        else:
            second = JaxAnalyzer(jp, JAX_TINY, text_cache=cache, **kw)
            texts = {k: np.asarray(getattr(second, k)) for k in saved}
    for k in saved:
        np.testing.assert_array_equal(texts[k], saved[k])
    px = _pixels(3, seed=32)
    a = {k: np.asarray(v) for k, v in first.classify_pixels(px).items()}
    b = {k: np.asarray(v) for k, v in second.classify_pixels(px).items()}
    _close_results(b, a)


def test_port_writes_the_jax_text_cache_layout(tmp_path, fp32_engines):
    ref, ours = fp32_engines
    path = str(tmp_path / "port.npz")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        InteriorAnalyzer(ours.params, TINY_TEST, training_data=TRAINING, device="cpu",
                         text_cache=path)
    with np.load(path) as blob:
        np.testing.assert_allclose(blob["det_text"], np.asarray(ref.det_text), atol=TOL, rtol=0)
        np.testing.assert_allclose(blob["cat_text"], np.asarray(ref.cat_text), atol=TOL, rtol=0)
        np.testing.assert_array_equal(blob["cat_mask"], np.asarray(ref.cat_mask))


def _write_images(root, kinds):
    from PIL import Image

    paths = []
    for i, kind in enumerate(kinds):
        if kind == "missing":
            paths.append(str(root / f"missing{i}.jpg"))
            continue
        arr = np.random.default_rng(40 + i).integers(0, 256, (40 + 4 * i, 52 - 2 * i, 3),
                                                     dtype=np.uint8)
        p = root / f"im{i}.{'jpg' if kind == 'jpeg' else 'png'}"
        Image.fromarray(arr).save(p, quality=90) if kind == "jpeg" else Image.fromarray(arr).save(p)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("kinds, device_resize", [
    (["jpeg"] * 5, False),
    (["jpeg", "jpeg", "missing", "jpeg"], False),
    (["jpeg", "png", "missing", "png", "jpeg"], False),
    (["jpeg"] * 5 + ["missing"], True),
], ids=["jpegs", "jpegs_missing", "mixed_png", "device_resize"])
@pytest.mark.parametrize("filter_interiors", [True, False], ids=["filter", "nofilter"])
def test_analyze_images_batch_matches_jax(fp32_engines, tmp_path, kinds, device_resize,
                                          filter_interiors):
    ref, ours = fp32_engines
    paths = _write_images(tmp_path, kinds)
    kw = dict(filter_interiors=filter_interiors, device_resize=device_resize)
    # the port in chunks of 2 (several stream batches); the JAX engine in one
    # batch, as its stream can lose its end behind two or more
    got = ours.analyze_images_batch(paths, batch_size=2, **kw)
    want = ref.analyze_images_batch(paths, batch_size=8, **kw)
    assert list(got) == list(want) and set(got) == set(paths)
    for p in paths:
        _same_result(got[p], want[p])
    for p, kind in zip(paths, kinds):
        if kind == "missing":
            assert got[p]["detected_category"] == "load error"
    if not filter_interiors:
        assert all(r["analysis"] for p, r in got.items() if "missing" not in p)


def test_single_image_helpers_match_jax(fp32_engines, tmp_path):
    from PIL import Image

    ref, ours = fp32_engines
    paths = _write_images(tmp_path, ["jpeg", "png", "missing"])
    img = Image.open(paths[0])
    got, want = ours.is_interior_image(img), ref.is_interior_image(img)
    assert got[0] == want[0] and got[2] == want[2] and abs(got[1] - want[1]) <= TOL
    assert ours.is_interior_image(None) == ref.is_interior_image(None)
    for threshold in (0.3, 0.0):
        gi, gn = ours.filter_interior_images(paths, confidence_threshold=threshold)
        wi, wn = ref.filter_interior_images(paths, confidence_threshold=threshold)
        assert [p for p, _, _ in gi] == [p for p, _, _ in wi]
        for (_, gpx, gc), (_, wpx, wc) in zip(gi, wi):
            np.testing.assert_array_equal(gpx, wpx)
            assert abs(gc - wc) <= TOL
        assert [{k: v for k, v in d.items() if k != "confidence"} for d in gn] == \
            [{k: v for k, v in d.items() if k != "confidence"} for d in wn]
        np.testing.assert_allclose([d["confidence"] for d in gn], [d["confidence"] for d in wn],
                                   atol=TOL, rtol=0)
    for p in paths:
        for filter_interiors in (True, False):
            g = ours.analyze_image_from_url(p, filter_interiors=filter_interiors)
            w = ref.analyze_image_from_url(p, filter_interiors=filter_interiors)
            if "missing" in p:
                assert g == w == {"is_interior": False, "reason": "Failed to load image"}
            else:
                _same_result(g, w)


def test_stage_timings_on_metrics(fp32_engines, tmp_path):
    _, ours = fp32_engines
    paths = _write_images(tmp_path, ["jpeg", "jpeg"])
    ours.analyze_images_batch(paths)
    ours.analyze_images_batch(paths, device_resize=True)
    stages = ours.metrics.stages.summary()
    assert {"dispatch", "fetch", "decode_stall", "decode"} <= set(stages)
    snap = ours.metrics.snapshot()
    assert snap["stage_fetch_count"] >= 2 and snap["stage_dispatch_count"] >= 2


def test_engine_refuses_a_mesh():
    with pytest.raises(ValueError, match="mesh"):
        InteriorAnalyzer(config=TINY_TEST, training_data=TRAINING, device="cpu", mesh=object())


@pytest.mark.parametrize("merges", [False, True], ids=["hermetic", "bpe_path"])
def test_hermetic_tokenizer_warning_on_loaded_weights(tmp_path, monkeypatch, merges):
    """Both engines warn that loaded weights meet the hermetic vocabulary;
    neither warns with ``AIIC_BPE_PATH`` at a merges file, or on the seeded
    init."""
    import gzip

    from aiic_tpu.data import tokenizer as jax_tok
    from aiic_tpu_torch.data import tokenizer as tok

    if merges:
        path = tmp_path / "bpe.txt.gz"
        with gzip.open(path, "wt", encoding="utf-8") as f:
            f.write("#version\n" + "w n\nwn ę\ns t\nst y\nk u\nku ch\n")
        monkeypatch.setenv("AIIC_BPE_PATH", str(path))
    else:
        monkeypatch.delenv("AIIC_BPE_PATH", raising=False)
    for t in (tok, jax_tok):
        t._default_tokenizer.cache_clear()
    try:
        jp = init_clip_params(jax.random.PRNGKey(6), JAX_TINY)
        for build in (lambda: JaxAnalyzer(jp, JAX_TINY, training_data=TRAINING, max_batch=2),
                      lambda: InteriorAnalyzer(params_from_numpy(flatten_params(jp)), TINY_TEST,
                                               training_data=TRAINING, max_batch=2,
                                               device="cpu")):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                build()
            hermetic = [w for w in caught if "HERMETIC" in str(w.message)]
            assert len(hermetic) == (0 if merges else 1), [str(w.message) for w in caught]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            InteriorAnalyzer(config=TINY_TEST, training_data=TRAINING, device="cpu")
        assert not [w for w in caught if "HERMETIC" in str(w.message)]
    finally:
        for t in (tok, jax_tok):
            t._default_tokenizer.cache_clear()
