"""The port's copies, weight bridge and import hygiene against the JAX package."""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from aiic_tpu.engine import detector as jax_detector
from aiic_tpu.models import config as jax_config
from aiic_tpu.models.init import flatten_params, init_clip_params as jax_init
from aiic_tpu_torch.engine import detector
from aiic_tpu_torch.models import config
from aiic_tpu_torch.models.init import (
    init_clip_params,
    load_clip_weights,
    params_from_numpy,
    save_clip_weights,
)
from aiic_tpu_torch.ops import quant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ["VIT_B_16", "VIT_B_32", "VIT_L_14", "VIT_L_14_336", "TINY_TEST"]


@pytest.mark.parametrize("name", PRESETS)
def test_config_presets_equal_jax(name):
    ours, ref = getattr(config, name), getattr(jax_config, name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for prop in ("grid_size", "num_patches", "vision_seq_len"):
        assert getattr(ours, prop) == getattr(ref, prop)
    assert ours.vision.mlp_dim == ref.vision.mlp_dim
    assert ours.text.head_dim == ref.text.head_dim


def test_detector_constants_equal_jax():
    assert detector.DETECTOR_CATEGORIES == jax_detector.DETECTOR_CATEGORIES
    assert len(detector.DETECTOR_CATEGORIES) == 40
    assert detector.INTERIOR_COUNT == jax_detector.INTERIOR_COUNT == 11
    assert detector.DEFAULT_CONFIDENCE_THRESHOLD == jax_detector.DEFAULT_CONFIDENCE_THRESHOLD


def _shapes(flat):
    return {k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in flat.items()}


def test_seeded_init_matches_jax_tree_shapes_and_dtypes():
    ref = flatten_params(jax_init(jax.random.PRNGKey(0), jax_config.TINY_TEST))
    ours = {k: v.numpy() for k, v in _flat_torch(
        init_clip_params(config.TINY_TEST, torch.Generator().manual_seed(0))).items()}
    assert _shapes(ours) == _shapes(ref)
    # the same distributions: OpenAI-CLIP stds, unit LN scales, zero biases
    std = ours["visual/blocks/attn/wqkv"].std()
    assert abs(std - config.TINY_TEST.vision.width ** -0.5) < 0.01
    assert (ours["visual/ln_pre/scale"] == 1).all() and (ours["text/blocks/mlp/b1"] == 0).all()
    np.testing.assert_allclose(ours["logit_scale"], np.log(1 / 0.07), rtol=1e-6)


def _flat_torch(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_torch(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_params_from_numpy_and_npz_round_trip(tmp_path):
    flat = flatten_params(jax_init(jax.random.PRNGKey(1), jax_config.TINY_TEST))
    params = params_from_numpy(flat)
    for k, v in _flat_torch(params).items():
        np.testing.assert_array_equal(v.numpy(), flat[k])
    path = str(tmp_path / "w.npz")
    save_clip_weights(params, path)
    back = load_clip_weights(path, dtype=torch.bfloat16)
    for k, v in _flat_torch(back).items():
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            v.float().numpy(), torch.from_numpy(np.array(flat[k])).to(torch.bfloat16).float().numpy())
    # a JAX-written npz reads back unchanged with numpy alone
    np.savez(str(tmp_path / "jax.npz"), **flat)
    for k, v in _flat_torch(load_clip_weights(str(tmp_path / "jax.npz"))).items():
        np.testing.assert_array_equal(v.numpy(), flat[k])


@pytest.mark.parametrize("name", ["int8_ln_mlp", "int8_ln_qkv_attention"])
def test_wrapper_takes_plain_version_on_cpu_without_counting(name):
    rng = np.random.default_rng(0)
    w = 64
    x = torch.from_numpy(rng.standard_normal((2, 8, w)).astype(np.float32)).to(torch.bfloat16)
    ones, zeros = torch.ones(w), torch.zeros(w)
    quant.reset_launch_counts()
    if name == "int8_ln_mlp":
        w1_q, s1 = quant.quantize_weight(torch.randn(w, 4 * w))
        w2_q, s2 = quant.quantize_weight(torch.randn(4 * w, w))
        args = (x, ones, zeros, w1_q, s1, torch.zeros(4 * w), w2_q, s2, zeros)
        out = quant.int8_ln_mlp(*args)
        ref = quant.int8_ln_mlp_ref(*args)
    else:
        wq, sq = quant.quantize_weight(torch.randn(w, 3 * w))
        args = (x, ones, zeros, wq, sq, torch.zeros(3 * w), torch.randn(w, w), zeros)
        out = quant.int8_ln_qkv_attention(*args, heads=4)
        ref = quant.int8_ln_qkv_attention_ref(*args, heads=4)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert getattr(quant, name).launches == 0
    with pytest.raises(RuntimeError, match="no kernel"):
        quant._route(name, x.to("meta"))


def test_batching_helpers_are_jax_free_and_reused():
    code = ("import sys; import aiic_tpu.utils.batching as b; import aiic_tpu.data.dataset; "
            "assert b.bucket_size(3, 8) == 4; assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import aiic_tpu_torch, aiic_tpu_torch.engine.analyzer, aiic_tpu_torch.ops.quant\n"
            "import aiic_tpu_torch.ops._build, aiic_tpu_torch.models.clip, chip_smoke\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_cuda_or_repo(tmp_path, alone):
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    cwd = str(tmp_path) if alone else REPO
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
