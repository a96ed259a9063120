"""The port's copies, weight bridge and import hygiene against the JAX package.

The port imports nothing of ``aiic_tpu``: its host helpers (tokenizer,
prompts, normalization constants, batch buckets) are copies, each held here
to its original on the CPU.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from aiic_tpu.data import dataset as jax_dataset
from aiic_tpu.data import preprocess as jax_data_pre
from aiic_tpu.data import tokenizer as jax_tokenizer
from aiic_tpu.engine import detector as jax_detector
from aiic_tpu.models import config as jax_config
from aiic_tpu.models.init import flatten_params, init_clip_params as jax_init
from aiic_tpu.utils import batching as jax_batching
from aiic_tpu_torch.data import dataset, tokenizer
from aiic_tpu_torch.data import preprocess as data_pre
from aiic_tpu_torch.engine import detector
from aiic_tpu_torch.models import config
from aiic_tpu_torch.models.init import (
    init_clip_params,
    load_clip_weights,
    params_from_numpy,
    save_clip_weights,
)
from aiic_tpu_torch.ops import _build, attention, block_grad, mlp, quant
from aiic_tpu_torch.probes import mxu_probe, variants
from aiic_tpu_torch.utils import batching

torch.set_num_threads(2)

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
    back = load_clip_weights(path, config.TINY_TEST, dtype=torch.bfloat16)
    for k, v in _flat_torch(back).items():
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            v.float().numpy(), torch.from_numpy(np.array(flat[k])).to(torch.bfloat16).float().numpy())
    # a JAX-written npz reads back unchanged with numpy alone
    np.savez(str(tmp_path / "jax.npz"), **flat)
    for k, v in _flat_torch(load_clip_weights(str(tmp_path / "jax.npz"), config.TINY_TEST)).items():
        np.testing.assert_array_equal(v.numpy(), flat[k])


KERNEL_WRAPPERS = ["int8_ln_mlp", "int8_ln_qkv_attention", "fused_attention_qkv",
                   "fused_ln_qkv_attention", "fused_ln_mlp", "text_block_fwd", "text_block_bwd",
                   "text_block_fwd_int8", "text_block_bwd_int8", "int8_ln_mlp_chunked",
                   "int8_block", "fused_attention_qkv_headgroups", "fused_attention",
                   "fused_attention_qkv_bwd", "mxu_bf16", "mxu_i8", "mxu_i8_quant",
                   "int8_attn_nomax", "mlp_var", "attn_var2", "mlp_var3", "attn_var4", "attn_var5",
                   "attn_var7", "gemm_stage"]


@pytest.mark.parametrize("name", KERNEL_WRAPPERS)
def test_wrapper_takes_plain_version_on_cpu_without_counting(name):
    rng = np.random.default_rng(0)
    w = 64
    x = torch.from_numpy(rng.standard_normal((2, 8, w)).astype(np.float32)).to(torch.bfloat16)
    ones, zeros = torch.ones(w), torch.zeros(w)
    _build.reset_launch_counts()
    if name == "int8_ln_mlp":
        w1_q, s1 = quant.quantize_weight(torch.randn(w, 4 * w))
        w2_q, s2 = quant.quantize_weight(torch.randn(4 * w, w))
        args = (x, ones, zeros, w1_q, s1, torch.zeros(4 * w), w2_q, s2, zeros)
        out = quant.int8_ln_mlp(*args)
        ref = quant.int8_ln_mlp_ref(*args)
    elif name == "int8_ln_qkv_attention":
        wq, sq = quant.quantize_weight(torch.randn(w, 3 * w))
        args = (x, ones, zeros, wq, sq, torch.zeros(3 * w), torch.randn(w, w), zeros)
        out = quant.int8_ln_qkv_attention(*args, heads=4)
        ref = quant.int8_ln_qkv_attention_ref(*args, heads=4)
    elif name == "gemm_stage":
        a = torch.from_numpy(rng.integers(-127, 128, (16, w)).astype(np.int8))
        wq, sq = quant.quantize_weight(torch.randn(w, 3 * w))
        kw = dict(row_scale=torch.rand(16), col_scale=sq, bias=torch.zeros(3 * w))
        out = quant.gemm_stage(a, wq, "qkv", **kw)
        ref = quant.gemm_stage_ref(a, wq, "qkv", **kw)
    elif name == "fused_attention_qkv":
        qkv = torch.randn(2, 8, 3 * w).to(torch.bfloat16)
        out = attention.fused_attention_qkv(qkv, heads=4)
        ref = attention.fused_attention_qkv_ref(qkv, None, 4)
    elif name == "fused_ln_qkv_attention":
        args = (x, ones, zeros, torch.randn(w, 3 * w), torch.zeros(3 * w), torch.randn(w, w), zeros)
        out = attention.fused_ln_qkv_attention(*args, heads=4)
        ref = attention.fused_ln_qkv_attention_ref(*args, heads=4)
    elif name == "int8_ln_mlp_chunked":
        w1_q, s1 = quant.quantize_weight(torch.randn(w, 4 * w))
        w2_q, s2 = quant.quantize_weight(torch.randn(4 * w, w))
        args = (x, ones, zeros, w1_q, s1, torch.zeros(4 * w), w2_q, s2, zeros)
        out = quant.int8_ln_mlp_chunked(*args, n_chunks=2)
        ref = quant.int8_ln_mlp_ref(*args, n_chunks=2)
    elif name == "int8_block":
        wq, sq = quant.quantize_weight(torch.randn(w, 3 * w))
        w1_q, s1 = quant.quantize_weight(torch.randn(w, 4 * w))
        w2_q, s2 = quant.quantize_weight(torch.randn(4 * w, w))
        args = (x, ones, zeros, wq, sq, torch.zeros(3 * w), torch.randn(w, w), zeros, None, ones,
                zeros, w1_q, s1, torch.zeros(4 * w), w2_q, s2, zeros)
        out = quant.int8_block(*args, heads=4, plan_override=("chunked", 1, 2))
        ref = quant.int8_block_ref(*args, heads=4, plan=("chunked", 1, 2))
    elif name == "fused_attention_qkv_headgroups":
        qkv = torch.randn(2, 8, 3 * w).to(torch.bfloat16)
        out = attention.fused_attention_qkv_headgroups(qkv, heads=4, head_group=2)
        ref = attention.fused_attention_qkv_headgroups_ref(qkv, None, 4)
    elif name == "fused_attention":
        q = torch.randn(2, 8, 4, 16).to(torch.bfloat16)
        out = attention.fused_attention(q, q, q)
        ref = attention.fused_attention_ref(q, q, q)
    elif name == "fused_attention_qkv_bwd":
        qkv = torch.randn(2, 8, 3 * w).to(torch.bfloat16)
        out = attention.fused_attention_qkv_bwd(qkv, None, x.float(), heads=4)
        ref = attention.fused_attention_qkv_bwd_ref(qkv, None, x, heads=4)
    elif name.startswith("mxu_"):
        x_bf, x_i8, w_bf, w_i8 = (t[:8, :32] if t.shape[0] == 128 else t[:32, :16]
                                  for t in mxu_probe.inputs("cpu", steps=1))
        xw = {"mxu_bf16": (x_bf, w_bf), "mxu_i8": (x_i8, w_i8), "mxu_i8_quant": (x_bf, w_i8)}
        out = getattr(mxu_probe, name)(*xw[name], 2)
        ref = getattr(mxu_probe, name + "_ref")(*xw[name], 2)
    elif name in variants.WRAPPER_VARIANTS:
        # scaled as init_clip_params: the no-clamp cores overflow on N(0, 1) weights
        wqkv_q, sqkv = quant.quantize_weight(torch.randn(w, 3 * w) * w ** -0.5)
        wo = torch.randn(w, w) * 0.1
        wo_q, so = quant.quantize_weight(wo)
        w1, w2 = torch.randn(w, 4 * w) * 0.1, torch.randn(4 * w, w) * 0.1
        (w1_q, s1), (w2_q, s2) = quant.quantize_weight(w1), quant.quantize_weight(w2)
        lp = {"ln1_s": ones, "ln1_b": zeros, "wqkv_q": wqkv_q, "sqkv": sqkv,
              "bqkv": torch.zeros(3 * w), "wo": wo, "bo": zeros, "wo_q": wo_q, "so": so,
              "ln2_s": ones, "ln2_b": zeros, "w1_q": w1_q, "s1": s1, "b1": torch.zeros(4 * w),
              "w2_q": w2_q, "s2": s2, "b2": zeros, "w1": w1, "w2": w2, "heads": 1}
        variant = variants.WRAPPER_VARIANTS[name][-1]
        out = variants.WRAPPERS[name](x, lp, variant)
        ref = variants.PLAIN[name](x, lp, variant)
    elif name == "fused_ln_mlp":
        args = (x, ones, zeros, torch.randn(w, 4 * w), torch.zeros(4 * w), torch.randn(4 * w, w),
                zeros)
        out = mlp.fused_ln_mlp(*args)
        ref = mlp.fused_ln_mlp_ref(*args)
    else:
        ln = {"scale": ones, "bias": zeros}
        bp = {"ln1": ln, "ln2": ln,
              "attn": {"wqkv": torch.randn(w, 3 * w) * 0.1, "bqkv": torch.zeros(3 * w),
                       "wo": torch.randn(w, w) * 0.1, "bo": zeros},
              "mlp": {"w1": torch.randn(w, 4 * w) * 0.1, "b1": torch.zeros(4 * w),
                      "w2": torch.randn(4 * w, w) * 0.1, "b2": zeros}}
        dims = {"out_proj": (w, w), "c_fc": (w, 4 * w), "c_proj": (4 * w, w)}
        lora = {k: {"A": torch.randn(i, 2), "B": torch.randn(2, o)} for k, (i, o) in dims.items()}
        mask = torch.triu(torch.full((8, 8), float("-inf")), diagonal=1)
        qw = {}
        for k, (grp, wk) in {"wqkv": ("attn", "wqkv"), "w1": ("mlp", "w1"),
                             "w2": ("mlp", "w2")}.items():
            qw[k + "_q"], qw[{"wqkv": "sqkv", "w1": "s1", "w2": "s2"}[k]] = \
                quant.quantize_weight(bp[grp][wk])
        kw = dict(heads=4, scaling=2.0)
        if name == "text_block_fwd":
            out = block_grad.text_block_fwd(x, mask, bp, lora, **kw)
            ref = block_grad.text_block_fwd_ref(x, mask, bp, lora, **kw)
        elif name == "text_block_bwd":
            out = block_grad.text_block_bwd(x, x, mask, bp, lora, **kw)[0]
            ref = block_grad.text_block_bwd_ref(x, x, mask, bp, lora, **kw)[0]
        elif name == "text_block_fwd_int8":
            out = block_grad.text_block_fwd_int8(x, mask, bp, qw, lora, **kw)
            ref = block_grad.text_block_fwd_int8_ref(x, mask, bp, qw, lora, **kw)
        else:
            out = block_grad.text_block_bwd_int8(x, x, mask, bp, qw, lora, **kw)[0]
            ref = block_grad.text_block_bwd_int8_ref(x, x, mask, bp, qw, lora, **kw)[0]
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert _build.launch_counts()[name] == 0
    assert set(_build.launch_counts()) == set(KERNEL_WRAPPERS)
    with pytest.raises(RuntimeError, match="no kernel"):
        _build.route(name, x.to("meta"))


def test_batching_helpers_are_jax_free_and_reused():
    """Importing the port (each subpackage's exports), its smoke script, its
    profiler and its twins of ``tools/eval_f1.py`` and
    ``tools/parity_report.py`` loads no JAX and no module of the ``aiic_tpu``
    package: the batching helpers and the other host helpers the engine
    reuses are the port's own copies."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tools')\n"
        "import aiic_tpu_torch, aiic_tpu_torch.engine.analyzer, aiic_tpu_torch.models.clip\n"
        "import aiic_tpu_torch.train, aiic_tpu_torch.cli.train_lora, aiic_tpu_torch.adapters\n"
        "import aiic_tpu_torch.ops.quant, aiic_tpu_torch.ops.attention, aiic_tpu_torch.ops.mlp\n"
        "import aiic_tpu_torch.probes.mxu_probe, aiic_tpu_torch.probes.variants\n"
        "import aiic_tpu_torch.probes.kernel_experiments\n"
        "import chip_smoke, torch_profile, profiler_loss, torch_eval_f1, torch_parity_report\n"
        "import aiic_tpu_torch.engine, aiic_tpu_torch.models, aiic_tpu_torch.data\n"
        "import aiic_tpu_torch.ops, aiic_tpu_torch.utils, aiic_tpu_torch.train.metrics\n"
        "from aiic_tpu_torch.utils.batching import bucket_size\n"
        "assert bucket_size(3, 8) == 4\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "bad = sorted(m for m in sys.modules if m == 'aiic_tpu' or m.startswith('aiic_tpu.'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


# Each subpackage exports the names of JAX's counterpart. The one name left
# out is utils.enable_compilation_cache: XLA's persistent compilation cache,
# which has no counterpart in the port.
NOT_PORTED = {"utils": {"enable_compilation_cache"}}


@pytest.mark.parametrize("sub", ["engine", "models", "data", "ops", "utils", "adapters"])
def test_subpackage_exports_match_jax(sub):
    import importlib

    ours = importlib.import_module(f"aiic_tpu_torch.{sub}")
    ref = importlib.import_module(f"aiic_tpu.{sub}")
    want = [n for n in ref.__all__ if n not in NOT_PORTED.get(sub, set())]
    assert sorted(ours.__all__) == sorted(want)
    for name in want:
        obj = getattr(ours, name)
        mod = getattr(obj, "__module__", None)
        assert mod is None or not mod.startswith("aiic_tpu."), (name, mod)
        if isinstance(getattr(ref, name), (str, int, float, list)):
            assert obj == getattr(ref, name), name
        elif isinstance(getattr(ref, name), np.ndarray):
            np.testing.assert_array_equal(obj, getattr(ref, name))


PREPROCESS_CASES = [(640, 479), (200, 300), (224, 224), (256, 256), (1000, 50), "zeros", "batch"]


@pytest.mark.parametrize("case", PREPROCESS_CASES, ids=lambda c: c if isinstance(c, str)
                         else f"{c[0]}x{c[1]}")
def test_preprocess_numpy_bit_for_bit_jax(case):
    """``preprocess_numpy`` / ``preprocess_numpy_batch`` on tests/
    test_preprocess.py's geometries, an all-zero image and a batch of mixed
    sizes: bit for bit the JAX package's."""
    rng = np.random.default_rng(3)
    if case == "batch":
        imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                for h, w in ((479, 640), (300, 200), (224, 224))]
        out, ref = data_pre.preprocess_numpy_batch(imgs), jax_data_pre.preprocess_numpy_batch(imgs)
        assert out.shape == (3, 224, 224, 3)
    else:
        img = (np.zeros((224, 224, 3), np.uint8) if case == "zeros"
               else rng.integers(0, 256, (case[1], case[0], 3), dtype=np.uint8))
        out, ref = data_pre.preprocess_numpy(img), jax_data_pre.preprocess_numpy(img)
        assert out.shape == (224, 224, 3)
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


PROMPTS = ["wnętrze w stylu skandynawskim", "Łazienka z płytkami — żółć, źdźbło, gęślą jaźń",
           "  kuchnia   ze  ŚCIANĄ &amp; oknem 3D!  ", "sypialnia's 12 poduszek"]
VOCAB = [
    {"image_path": "x.jpg", "style": "nowoczesny",
     "characteristics": ["czyste linie", "przestronne"], "materials": ["drewno"],
     "colors": ["biały", "szary"], "room_type": "kuchnia"},
    {"image_path": "y.jpg", "style": "klasyczny", "characteristics": ["eleganckie", ""],
     "materials": ["marmur", "drewno"], "colors": ["beżowy"], "room_type": "salon"},
    {"image_path": "z.jpg", "style": "", "room_type": "łazienka"},
]


def _bpe_file(tmp_path):
    import gzip

    path = tmp_path / "bpe.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version\n" + "w n\nwn ę\ns t\nst y\nk u\nku ch\n")
    return str(path)


@pytest.mark.parametrize("case", ["tokenize_for_model", "tokenizer_bpe_env", "category_prompts",
                                  "batching", "clip_mean_std", "training_data", "preprocess",
                                  "pth_layout", "lora_fold", "model_presets"])
def test_port_copies_match_jax_package(case, tmp_path, monkeypatch):
    if case == "tokenize_for_model":
        for name in ("TINY_TEST", "VIT_B_16"):
            np.testing.assert_array_equal(
                tokenizer.tokenize_for_model(PROMPTS, getattr(config, name)),
                jax_tokenizer.tokenize_for_model(PROMPTS, getattr(jax_config, name)))
        assert tokenizer.ClipTokenizer().hermetic and jax_tokenizer.ClipTokenizer().hermetic
    elif case == "tokenizer_bpe_env":
        monkeypatch.setenv("AIIC_BPE_PATH", _bpe_file(tmp_path))
        ours, ref = tokenizer.ClipTokenizer(), jax_tokenizer.ClipTokenizer()
        assert not ours.hermetic and ours.bpe_ranks == ref.bpe_ranks
        np.testing.assert_array_equal(ours(PROMPTS), ref(PROMPTS))
        assert ours.decode(ours(PROMPTS[0])[0]) == ref.decode(ref(PROMPTS[0])[0])
    elif case == "category_prompts":
        cats = dataset.extract_all_categories(VOCAB)
        assert cats == jax_dataset.extract_all_categories(VOCAB)
        assert dataset.build_category_prompts(cats) == jax_dataset.build_category_prompts(cats)
        assert dataset.CATEGORY_KEYS == jax_dataset.CATEGORY_KEYS
    elif case == "batching":
        for n, cap in [(1, 8), (3, 8), (8, 8), (9, 8), (5, 512), (300, 256)]:
            assert batching.bucket_size(n, cap) == jax_batching.bucket_size(n, cap)
        a = np.arange(3 * 4, dtype=np.uint8).reshape(3, 4)
        for size in (3, 4, 8):
            ours, ref = batching.pad_batch(a, size), jax_batching.pad_batch(a, size)
            np.testing.assert_array_equal(ours[0], ref[0])
            assert ours[1] == ref[1] and ours[0].dtype == ref[0].dtype
        for mod in (batching, jax_batching):
            with pytest.raises(ValueError):
                mod.bucket_size(0, 8)
            with pytest.raises(ValueError):
                mod.pad_batch(a, 2)
    elif case == "clip_mean_std":
        np.testing.assert_array_equal(data_pre.CLIP_MEAN, jax_data_pre.CLIP_MEAN)
        np.testing.assert_array_equal(data_pre.CLIP_STD, jax_data_pre.CLIP_STD)
        assert data_pre.CLIP_MEAN.dtype == jax_data_pre.CLIP_MEAN.dtype
    elif case == "training_data":
        path = tmp_path / "d.json"
        path.write_text(json.dumps({"training_data": VOCAB}), encoding="utf-8")
        assert dataset.load_training_data(str(path)) == jax_dataset.load_training_data(str(path))
        for item in VOCAB[:2] + [{"style": "boho"}]:
            assert dataset.build_training_prompts(item) == jax_dataset.build_training_prompts(item)
    elif case == "preprocess":
        _check_preprocess_copy()
    elif case == "pth_layout":
        _check_pth_layout_copy(tmp_path)
    elif case == "lora_fold":
        _check_lora_copy()
    else:
        from aiic_tpu.cli.common import model_presets as jax_presets
        from aiic_tpu_torch.cli.common import model_presets

        ours, ref = model_presets(), jax_presets()
        assert list(ours) == list(ref)
        assert all(dataclasses.asdict(ours[k]) == dataclasses.asdict(ref[k]) for k in ours)


def _check_preprocess_copy():
    from PIL import Image

    rng = np.random.default_rng(0)
    for size in ((640, 480), (100, 300), (224, 224), (60, 40)):
        assert data_pre.resize_target(*size, 224) == jax_data_pre.resize_target(*size, 224)
        assert data_pre.center_crop_bounds(*size, 224) == jax_data_pre.center_crop_bounds(*size, 224)
        np.testing.assert_array_equal(data_pre.resize_matrix(size[0], 224),
                                      jax_data_pre.resize_matrix(size[0], 224))
        img = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
        np.testing.assert_array_equal(data_pre.resize_bicubic_numpy(img, 50, 40),
                                      jax_data_pre.resize_bicubic_numpy(img, 50, 40))
        pil = Image.fromarray(img)
        np.testing.assert_array_equal(data_pre.preprocess_pil_u8(pil, 32),
                                      jax_data_pre.preprocess_pil_u8(pil, 32))
        np.testing.assert_array_equal(data_pre.preprocess_pil(pil.convert("L"), 32),
                                      jax_data_pre.preprocess_pil(pil.convert("L"), 32))


def _check_pth_layout_copy(tmp_path):
    from aiic_tpu.adapters import LoRAConfig as JaxLoRAConfig
    from aiic_tpu.adapters import torch_convert as jax_convert
    from aiic_tpu_torch.adapters import LoRAConfig, torch_convert

    for key in ("clip_model.transformer.resblocks.3.mlp.c_fc.lora.lora_A",
                "visual.transformer.resblocks.0.attn.out_proj.lora.lora_B",
                "transformer.resblocks.11.mlp.c_proj.lora.lora_B", "logit_scale"):
        assert torch_convert.parse_lora_key(key) == jax_convert.parse_lora_key(key)
    rng = np.random.default_rng(1)
    tree = {p: {"A": rng.standard_normal((2, i, 3)).astype(np.float32),
                "B": rng.standard_normal((2, 3, o)).astype(np.float32)}
            for p, (i, o) in {"c_fc": (32, 128), "out_proj": (32, 32)}.items()}
    ours = torch_convert.lora_tree_to_pth_dict({p: {k: torch.from_numpy(v) for k, v in d.items()}
                                                for p, d in tree.items()})
    ref = jax_convert.lora_tree_to_pth_dict(tree)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
        assert ours[k].dtype == ref[k].dtype
    path = str(tmp_path / "a.pth")
    torch_convert.save_lora_pth({p: {k: torch.from_numpy(v) for k, v in d.items()}
                                 for p, d in tree.items()}, path)
    assert torch_convert.infer_lora_rank(path) == jax_convert.infer_lora_rank(path) == 3
    attach = ("c_fc", "c_proj", "out_proj")
    got, meta = torch_convert.lora_tree_from_pth(path, config.TINY_TEST,
                                                 LoRAConfig(3, 6, attach), device="cpu")
    want, jmeta = jax_convert.lora_tree_from_pth(path, jax_config.TINY_TEST,
                                                 JaxLoRAConfig(3, 6, attach))
    assert meta == jmeta
    for p in ("c_fc", "out_proj"):  # loaded; c_proj keeps a fresh (seeded) init
        for ab in "AB":
            np.testing.assert_array_equal(got[p][ab].numpy(), np.asarray(want[p][ab]))
    assert float(got["c_proj"]["B"].abs().max()) == 0.0
    assert got["c_proj"]["A"].shape == want["c_proj"]["A"].shape


def _check_lora_copy():
    from aiic_tpu.adapters import lora as jax_lora
    from aiic_tpu_torch.adapters import lora

    assert lora.ATTACH_POINTS == jax_lora.ATTACH_POINTS
    assert lora.LoRAConfig(16, 32).scaling == jax_lora.LoRAConfig(16, 32).scaling == 2.0
    for point in lora.ATTACH_POINTS:
        assert lora._dims(point, 32, 128) == jax_lora._dims(point, 32, 128)
    flat = flatten_params(jax_init(jax.random.PRNGKey(2), jax_config.TINY_TEST))
    params = params_from_numpy(flat)
    cfg = lora.LoRAConfig(2, 4, ("c_fc", "c_proj", "out_proj"))
    tree = lora.init_text_lora(torch.Generator().manual_seed(0), config.TINY_TEST, cfg,
                               device="cpu")
    ref_tree = jax_lora.init_text_lora(jax.random.PRNGKey(0), jax_config.TINY_TEST, cfg)
    assert {p: {k: tuple(v.shape) for k, v in d.items()} for p, d in tree.items()} == {
        p: {k: tuple(v.shape) for k, v in d.items()} for p, d in ref_tree.items()}
    assert lora.lora_param_count(tree) == jax_lora.lora_param_count(ref_tree)
    assert abs(float(tree["c_fc"]["A"].std()) - 0.02) < 0.003
    for d in tree.values():
        d["B"] = torch.randn(d["B"].shape, generator=torch.Generator().manual_seed(1))
    folded = lora.fold_text_lora(params, tree, 2.0)
    ref = jax_lora.fold_text_lora(
        jax.tree.map(jax.numpy.asarray, _nested(flat)),
        {p: {k: jax.numpy.asarray(v.numpy()) for k, v in d.items()} for p, d in tree.items()}, 2.0)
    for grp, name in (("mlp", "w1"), ("mlp", "w2"), ("attn", "wo")):
        np.testing.assert_allclose(folded["text"]["blocks"][grp][name].numpy(),
                                   np.asarray(ref["text"]["blocks"][grp][name]), rtol=0, atol=1e-6)
    assert folded["visual"] is params["visual"]


def _nested(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    return tree


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import aiic_tpu_torch, aiic_tpu_torch.engine.analyzer, aiic_tpu_torch.ops.quant\n"
            "import aiic_tpu_torch.ops._build, aiic_tpu_torch.models.clip, chip_smoke\n"
            "import aiic_tpu_torch.ops.attention, aiic_tpu_torch.ops.mlp\n"
            "import aiic_tpu_torch.ops.block_grad, aiic_tpu_torch.train.trainer\n"
            "import aiic_tpu_torch.train.checkpoint, aiic_tpu_torch.train.evaluate\n"
            "import aiic_tpu_torch.cli.train_lora, aiic_tpu_torch.adapters.torch_convert\n"
            "import aiic_tpu_torch.serve.app, aiic_tpu_torch.serve.worker\n"
            "import aiic_tpu_torch.serve.rest, aiic_tpu_torch.serve.batcher\n"
            "import aiic_tpu_torch.serve.db, aiic_tpu_torch.serve.metrics\n"
            "import aiic_tpu_torch.cli.worker, aiic_tpu_torch.cli.main, aiic_tpu_torch.cli.common\n"
            "import aiic_tpu_torch.data.pipeline, aiic_tpu_torch.data.native_loader\n"
            "import aiic_tpu_torch.data.images, aiic_tpu_torch.ops.preprocess\n"
            "import aiic_tpu_torch.utils.profiling, aiic_tpu_torch.utils.logging\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
            "bad = sorted(m for m in sys.modules if m == 'aiic_tpu' or m.startswith('aiic_tpu.'))\n"
            "assert not bad, bad\n")
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


class _KernelEvent:
    """A CUDA kernel's line of ``key_averages()``: name, count, device us."""
    device_type = torch.autograd.DeviceType.CUDA

    def __init__(self, key, count):
        self.key, self.count, self.self_device_time_total = key, count, 10.0 * count


_WHOLE = [_KernelEvent("void wgmma_stage_kernel<EpiGelu>", 6), _KernelEvent("rowquant_kernel", 3)]
_WHOLE_B = [_KernelEvent("void wgmma_stage_kernel<EpiGelu>", 6), _KernelEvent("rowquant_kernel", 6)]
_LOST_STAGE = [_KernelEvent("void wgmma_stage_kernel<EpiGelu>", 3), _KernelEvent("rowquant_kernel", 3)]
_LOST_ROW = [_KernelEvent("void wgmma_stage_kernel<EpiGelu>", 6), _KernelEvent("rowquant_kernel", 2)]


@pytest.mark.parametrize("traces, row_ms", [
    ([_LOST_STAGE, _WHOLE, _WHOLE], 0.01),
    ([_WHOLE, _LOST_ROW, _WHOLE, _WHOLE], 0.01),
    ([_WHOLE, _WHOLE_B, _WHOLE_B], 0.02),
    ([_LOST_STAGE, _LOST_ROW, _WHOLE, _LOST_STAGE, _WHOLE], None),
    ([[], []], None),
], ids=["lost_stage_first", "lost_row_between", "counts_changed", "never_two_whole", "empty"])
def test_device_ms_by_kernel_uses_only_agreeing_whole_traces(monkeypatch, traces, row_ms):
    """chip_smoke's one profiler path: a trace with fewer stage kernels than
    ``quant.gemm_stage`` counted, or a count that is not a multiple of the
    calls, is not used; the trace used is whole and counts what the whole
    trace before it counted; else the run fails."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    from aiic_tpu_torch.ops import quant

    left = list(traces)

    def trace(fn, lead_in=chip_smoke.PROFILE_LEAD_IN):
        for _ in range(chip_smoke.PROFILE_ITERS):
            fn()
        return left.pop(0)

    def two_stage_launches():
        quant.gemm_stage.launches += 2

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(quant.gemm_stage, "launches", 0)
    monkeypatch.setattr(chip_smoke, "_trace", trace)
    monkeypatch.setattr(chip_smoke, "PROFILE_TRIES", len(traces))
    needles = {"stage": "wgmma_stage_kernel", "row_pass": "rowquant_kernel", "core": "attn_core"}
    if row_ms is None:
        with pytest.raises(AssertionError, match="no two whole ones in a row"):
            chip_smoke._device_ms_by_kernel(two_stage_launches, needles)
        return
    got = chip_smoke._device_ms_by_kernel(two_stage_launches, needles)
    assert not left
    assert got == {"stage": pytest.approx(0.02), "row_pass": pytest.approx(row_ms), "core": None}


@pytest.mark.parametrize("row", ["fused_ln_qkv_attention", "fused_ln_mlp", None],
                         ids=["row5", "row10", "uncounted"])
def test_device_ms_by_kernel_counts_the_bf16_rows_stage_launches(monkeypatch, row):
    """Rows 5 and 10 launch the stage twice a call and count one launch of
    their own, none of ``quant.gemm_stage``'s: a trace of them is whole with
    two stage kernels a counted launch; stage kernels that no wrapper
    counted make no trace whole."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    from aiic_tpu_torch.ops import _build

    def trace(fn, lead_in=chip_smoke.PROFILE_LEAD_IN):
        for _ in range(chip_smoke.PROFILE_ITERS):
            fn()
        return _WHOLE

    def one_call():
        if row is not None:
            _build._COUNTED[row].launches += 1

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    for fn in _build._COUNTED.values():
        monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(chip_smoke, "_trace", trace)
    needles = {"stage": "wgmma_stage_kernel"}
    if row is None:
        with pytest.raises(AssertionError, match="no two whole ones in a row"):
            chip_smoke._device_ms_by_kernel(one_call, needles)
        return
    got = chip_smoke._device_ms_by_kernel(one_call, needles)
    assert got == {"stage": pytest.approx(0.02)}


@pytest.mark.parametrize("row,per_call", [("text_block_fwd", 4), ("text_block_bwd", 7),
                                          ("text_block_fwd_int8", 4), ("text_block_bwd_int8", 7)])
def test_device_ms_by_kernel_counts_the_text_blocks_stage_launches(monkeypatch, row, per_call):
    """Rows 11-14 in bf16 and int8 (form 0) launch the stage four times a
    forward and seven a backward inside one counted launch of their own: a
    trace with that many stage kernels a call is whole, one with a stage
    kernel lost is not."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    from aiic_tpu_torch.ops import _build

    assert chip_smoke.BF16_STAGE_LAUNCHES[row] == per_call
    n = per_call * chip_smoke.PROFILE_ITERS
    for events, whole in (([_KernelEvent("void wgmma_stage_kernel<EpiFc<bf16>>", n)], True),
                          ([_KernelEvent("void wgmma_stage_kernel<EpiFc<bf16>>", n - 1)], False)):
        def trace(fn, lead_in=chip_smoke.PROFILE_LEAD_IN):
            for _ in range(chip_smoke.PROFILE_ITERS):
                fn()
            return events

        def one_call():
            _build._COUNTED[row].launches += 1

        monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
        for fn in _build._COUNTED.values():
            monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(chip_smoke, "_trace", trace)
        needles = {"stage": "wgmma_stage_kernel"}
        if whole:
            got = chip_smoke._device_ms_by_kernel(one_call, needles)
            assert got["stage"] == pytest.approx(n * 0.01 / chip_smoke.PROFILE_ITERS)
        else:
            with pytest.raises(AssertionError, match="no two whole ones in a row"):
                chip_smoke._device_ms_by_kernel(one_call, needles)
