"""The port's classify program and InteriorAnalyzer against the JAX engine.

Both engines get the same weights and the fixture vocabulary of
tests/test_engine.py, in the serving configuration (bf16, int8, patch wire;
the JAX kernels in interpret mode). Verdicts, categories and attribute names
must be identical; confidences agree within 1e-3. Top-k ties may be
ordered differently by torch.topk and lax.top_k, so indices are compared
only where the values differ.

The JAX programs are compiled with ``xla_allow_excess_precision`` off. By
default XLA on the CPU may keep a bf16 intermediate in fp32, while the port
(like the Hopper kernels) rounds each bf16 result. With 100x softmax
temperatures at the tiny test width, that alone moves confidences by ~1e-2;
with every bf16 rounding kept, the two engines agree to ~1e-6.
"""

import functools

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
from aiic_tpu_torch.ops import quant

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
    quant.reset_launch_counts()
    ours = InteriorAnalyzer(params_from_numpy(flatten_params(jp)), TINY_TEST,
                            training_data=TRAINING, dtype=torch.bfloat16, quantize=True,
                            wire_format="patch", max_batch=4, device="cpu")
    return ref, ours


EXACT_BF16 = {"xla_allow_excess_precision": False}


def _jax_classify(ref, pm):
    """The JAX engine's classify program with every bf16 rounding kept."""
    fn = jax.jit(functools.partial(
        jax_programs.classify_batch, config=JAX_TINY, interior_count=INTERIOR_COUNT,
        dtype=jnp.bfloat16, attn_impl="pallas"), compiler_options=EXACT_BF16)
    out = fn(ref.params, jnp.asarray(pm), ref.det_text, ref.cat_text, ref.cat_mask)
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
    res = _jax_classify(ref, to_patch_major(px, TINY_TEST.patch_size))
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


@pytest.mark.parametrize("filter_interiors", [True, False], ids=["filter", "nofilter"])
def test_analyze_pixels_matches_jax_engine(engines, filter_interiors):
    ref, ours = engines
    px = _pixels(5, seed=8)  # max_batch=4: a full chunk and a padded one
    got = ours.analyze_pixels(px, filter_interiors=filter_interiors)
    want = _jax_results(ref, px, 0.3, filter_interiors)
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
