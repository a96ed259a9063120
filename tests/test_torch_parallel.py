"""The port's multi-device programs (``aiic_tpu_torch.parallel``) against the
JAX package's ``aiic_tpu.parallel``, on the CPU: the twin of
tests/test_parallel.py.

The port's meshes are gloo worlds of separate processes
(tests/torch_ranks.py): one world of 4 ranks, started once for the module,
runs every case on the meshes (4, 1), (2, 2) and (1, 4) and writes each
rank's outputs; every rank must hold the whole batch's result. While the
ranks run, this process computes the references: the JAX function on
conftest's 8-device CPU mesh (GSPMD) where it is cheap enough for the
module's time (the image encode, the classify program and the train step
at tp=2), the JAX single-device function, and the port's single-device
run (which tests/test_torch_train.py and tests/test_torch_engine.py hold
against JAX). The mesh of one (a world of one, in this process) serves the
analyzer's serving assembly and the device_resize warning.

Bars, JAX's own: 1e-5 on features, losses (relative), adapters and
gradients; 2e-5 at ViT-B/16 and ViT-L/14 (published widths, two blocks,
the text vocabulary cut: an image encode never reads it). The bf16/int8
serving programs: tests/test_torch_engine.py's serving bars (verdicts and
top-1 equal, confidences within 1e-3) and 1e-5 where CPU GEMMs of another
batch size round no row differently. An Adam step moves an element by
about lr whatever its gradient, so adapters are held at 1e-5 where the
gradient is clear of fp32 summation noise (1e-3 of its largest entry) and
within 2 lr elsewhere, as tests/test_torch_train.py holds them.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import torch_ranks as tr
from aiic_tpu.models import config as jax_config
from aiic_tpu.models.clip import encode_image as jax_encode_image
from aiic_tpu.models.clip import normalize_features as jax_normalize
from aiic_tpu.models.init import init_clip_params as jax_init
from aiic_tpu.parallel import create_mesh as jax_create_mesh
from aiic_tpu.parallel import mesh_shape_for as jax_mesh_shape_for
from aiic_tpu.parallel import sharding as jax_sharding
from aiic_tpu_torch.models import config
from aiic_tpu_torch.models.clip import encode_image, normalize_features
from aiic_tpu_torch.models.init import flatten_params as torch_flatten
from aiic_tpu_torch.models.init import params_from_numpy, tree_map
from aiic_tpu_torch.parallel import (
    create_mesh, lora_pspecs, mesh_shape_for, param_pspecs, shard_train_step,
)
from aiic_tpu_torch.parallel import mesh as mesh_mod
from aiic_tpu_torch.train import trainer

torch.set_num_threads(2)

CFG = config.TINY_TEST
JCFG = jax_config.TINY_TEST
POINTS = ("out_proj", "c_fc", "c_proj")
TRAIN = dict(epochs=2, batch_size=8, rank=2, alpha=4, attach=list(POINTS), attn_impl="xla",
             image_attn_impl="xla")
TOL = 1e-5
WIDE_TOL = 2e-5


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    return tree


def _lora_np(seed=1, rank=2):
    rng = np.random.default_rng(seed)
    w, m, layers = CFG.text.width, CFG.text.mlp_dim, CFG.text.layers
    dims = {"out_proj": (w, w), "c_fc": (w, m), "c_proj": (m, w)}
    return {p: {"A": (rng.standard_normal((layers, dims[p][0], rank)) * 0.02).astype(np.float32),
                "B": (rng.standard_normal((layers, rank, dims[p][1])) * 0.02).astype(np.float32)}
            for p in POINTS}


def _torch_tree(tree):
    return {p: {ab: torch.from_numpy(np.array(v)) for ab, v in d.items()} for p, d in tree.items()}


def _jax_cfg(name):
    cfg = getattr(jax_config, name)
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, layers=2),
                               text=dataclasses.replace(cfg.text, layers=1), vocab_size=64)


def _inputs(d):
    """Every input the ranks read, written with numpy into ``d``."""
    rng = np.random.default_rng(0)
    s = CFG.image_size
    px = rng.standard_normal((8, s, s, 3)).astype(np.float32)
    np.save(d / "px.npy", px)
    px224 = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    np.save(d / "px224.npy", px224)
    tokens = rng.integers(1, CFG.vocab_size - 2, (8, CFG.context_length)).astype(np.int32)
    tokens[:, 0] = CFG.vocab_size - 2
    tokens[:, -1] = CFG.vocab_size - 1
    np.savez(d / "train.npz", x=px, tokens=tokens)
    pool = rng.integers(1, CFG.vocab_size - 2, (3, CFG.context_length)).astype(np.int32)
    pool[:, -1] = CFG.vocab_size - 1
    ids = rng.integers(0, 3, (8,)).astype(np.int32)
    np.savez(d / "pool.npz", x=px, tokens=ids, pool=pool)

    def classify_inputs(pixels, dim):
        det = rng.standard_normal((40, dim)).astype(np.float32)
        det /= np.linalg.norm(det, axis=-1, keepdims=True)
        cat = rng.standard_normal((2, 6, dim)).astype(np.float32)
        return dict(pixels=pixels, det=det, cat=cat, mask=np.ones((2, 6), bool))
    cls = classify_inputs(px, CFG.embed_dim)
    np.savez(d / "cls.npz", **cls)
    srv = classify_inputs(rng.integers(0, 255, (8, s, s, 3), dtype=np.uint8), CFG.embed_dim)
    np.savez(d / "srv.npz", **srv)
    srv224 = classify_inputs(rng.integers(0, 255, (8, 224, 224, 3), dtype=np.uint8),
                             config.VIT_B_16.embed_dim)
    np.savez(d / "srv224.npz", **srv224)
    u8 = rng.integers(0, 255, (5, s, s, 3), dtype=np.uint8)  # odd: the bucket rounds 5 -> 8
    np.save(d / "u8_5.npy", u8)
    return dict(px=px, px224=px224, tokens=tokens, pool=pool, ids=ids, cls=cls, srv=srv,
                srv224=srv224, u8=u8)


CASES = (
    [dict(name=f"encode_tp{t}", case="encode", tp=t, pixels="px.npy") for t in (1, 2, 4)]
    + [dict(name="encode_b16", case="encode", tp=2, pixels="px224.npy", preset="VIT_B_16",
            seed=3),
       dict(name="encode_l14", case="encode", tp=4, pixels="px224.npy", preset="VIT_L_14",
            seed=4),
       dict(name="classify_xla", case="classify", tp=2, kernels=False, inputs="cls.npz"),
       dict(name="classify_kernels", case="classify", tp=2, kernels=True, inputs="srv.npz"),
       dict(name="classify_b16", case="classify", tp=2, kernels=True, inputs="srv224.npz",
            preset="VIT_B_16", seed=3)]
    + [dict(name=f"train_tp{t}", case="train", tp=t, inputs="train.npz", cfg=TRAIN,
            replicate_visual=False, replicate_text=False) for t in (1, 2, 4)]
    + [dict(name=f"train_{impl}", case="train", tp=2, inputs="train.npz",
            cfg=dict(TRAIN, attn_impl=impl), replicate_visual=True, replicate_text=True)
       for impl in ("block_fused", "pallas_vjp")]
    + [dict(name="train_quant_image", case="train", tp=2, inputs="train.npz",
            cfg=dict(TRAIN, attach=["c_fc", "c_proj"], image_attn_impl="pallas",
                     quantize_image=True), replicate_visual=True, replicate_text=False),
       dict(name="train_pool", case="train", tp=1, inputs="pool.npz",
            cfg=dict(TRAIN, attn_impl="block_fused"), replicate_visual=True,
            replicate_text=True),
       dict(name="train_dropout", case="train", tp=2, inputs="train.npz",
            cfg=dict(TRAIN, lora_dropout=0.1), replicate_visual=False, replicate_text=False,
            dropout_seed=5),
       dict(name="analyzer_hwc", case="analyzer", tp=1, wire="hwc", pixels="u8_5.npy"),
       dict(name="analyzer_patch", case="analyzer", tp=2, wire="patch", pixels="u8_5.npy")]
)


def _port_step(params, inputs, cfg, pool=None, generator=None):
    """The port's single-device step: loss, new adapters, gradients."""
    tc = trainer.TrainConfig(**cfg)
    if tc.quantize_image:
        from aiic_tpu_torch.ops.quant import quantize_model_mlp

        params = quantize_model_mlp(params, attn=True, towers=("visual",))
    opt = tr._Recording(trainer.make_optimizer(tc, 1))
    ts, _ = trainer.make_train_step(CFG, tc, opt, prompt_pool=pool, device="cpu")
    lora = _torch_tree(_lora_np())
    loss, new, _ = ts(params, lora, opt.init(lora), torch.from_numpy(inputs[0]),
                      torch.from_numpy(inputs[1]), generator)
    return {"loss": float(loss), "lora": tr._flat(tr._np(new)), "grads": tr._flat(tr._np(opt.grads))}


def _jax_step(jparams, x, tokens, mesh_tp=None):
    """JAX's step at the same inputs, single-device or on its 8-device mesh."""
    from aiic_tpu.train import trainer as jt

    cfg = jt.TrainConfig(**dict(TRAIN, attach=tuple(POINTS)))
    opt = jt.make_optimizer(cfg, 1)
    lora = jax.tree.map(jnp.asarray, _lora_np())
    ostate = opt.init(lora)
    ts, es = jt.make_train_step(JCFG, cfg, opt)
    if mesh_tp is None:
        loss, new, _ = jax.jit(ts)(jparams, lora, ostate, jnp.asarray(x), jnp.asarray(tokens),
                                   jax.random.PRNGKey(0))
    else:
        step, _, sp, sl, so = jax_sharding.shard_train_step(
            jax_create_mesh(8, tp=mesh_tp), ts, es, jparams, lora, ostate)
        loss, new, _ = step(sp, sl, so, jnp.asarray(x), jnp.asarray(tokens),
                            jax.random.PRNGKey(0))
    return {"loss": float(loss), "lora": {f"{p}/{ab}": np.asarray(new[p][ab])
                                          for p in POINTS for ab in "AB"}}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return tr.once_per_run(tmp_path_factory, "world4", _world4)


def _world4(d):
    """The 4-rank world's outputs and the references, computed meanwhile."""
    import aiic_tpu.engine.programs as jax_programs

    flat = torch_flatten(tr.seeded_params("TINY_TEST", 0))
    jp = jax.tree.map(jnp.asarray, _unflatten(flat))
    np.savez(d / "params.npz", **flat)
    tr.save_tree(d / "lora.npz", _lora_np())
    ins = _inputs(d)
    procs = tr.start(d, 4, CASES)
    try:
        params = params_from_numpy(flat)
        ref = {}
        # the image encode: port single-device, JAX single-device and on its mesh
        ref["encode"] = normalize_features(encode_image(params, torch.from_numpy(ins["px"]), CFG,
                                                        attn_impl="xla")).numpy()
        ref["jax_encode"] = np.asarray(jax_normalize(jax.jit(
            lambda p, x: jax_encode_image(p, x, JCFG))(jp, jnp.asarray(ins["px"]))))
        jmesh = jax_create_mesh(8, tp=2)
        with jmesh:
            ref["jax_encode_mesh"] = np.asarray(jax_normalize(jax_encode_image(
                jax_sharding.shard_params(jp, jmesh), jnp.asarray(ins["px"]), JCFG)))
        for name in ("VIT_B_16", "VIT_L_14"):
            p = tr.seeded_params(name, 3 if name == "VIT_B_16" else 4)
            ref[name] = normalize_features(encode_image(
                p, torch.from_numpy(ins["px224"]), tr.reduced_config(name),
                attn_impl="xla")).numpy()
        jpar = jax.tree.map(jnp.asarray, _unflatten(torch_flatten(tr.seeded_params("VIT_L_14", 4))))
        ref["jax_VIT_L_14"] = np.asarray(jax_normalize(jax_encode_image(
            jpar, jnp.asarray(ins["px224"]), _jax_cfg("VIT_L_14"))))
        # the classify programs
        from aiic_tpu_torch.engine.programs import classify_batch
        from aiic_tpu_torch.ops.quant import quantize_model

        cls = {k: torch.from_numpy(v) for k, v in ins["cls"].items()}
        ref["classify_xla"] = tr._np(classify_batch(
            params, cls["pixels"], cls["det"], cls["cat"], cls["mask"], config=CFG,
            interior_count=11, dtype=torch.float32, attn_impl="xla", topk=5))
        jfn = functools.partial(jax_programs.classify_batch, config=JCFG, interior_count=11,
                                dtype=jnp.float32, attn_impl="xla", topk=5)
        ref["jax_classify_mesh"] = {k: np.asarray(v) for k, v in jax_sharding.
                                    make_sharded_classify_fn(jmesh, jfn, jp)(
            jax_sharding.shard_params(jp, jmesh),
            *(jnp.asarray(ins["cls"][k]) for k in ("pixels", "det", "cat", "mask"))).items()}
        for name, tree, key, cfg in (
                ("classify_kernels", params, "srv", CFG),
                ("classify_b16", tr.seeded_params("VIT_B_16", 3), "srv224",
                 tr.reduced_config("VIT_B_16"))):
            q = quantize_model(tree_map(lambda t: t.to(torch.bfloat16), tree))
            srv = {k: torch.from_numpy(v) for k, v in ins[key].items()}
            ref[name] = tr._np(classify_batch(
                q, srv["pixels"], srv["det"], srv["cat"], srv["mask"], config=cfg,
                interior_count=11, dtype=torch.bfloat16, attn_impl="pallas", topk=5))
        # the train steps
        dense = (ins["px"], ins["tokens"])
        ref["train"] = _port_step(params, dense, TRAIN)
        ref["jax_train"] = _jax_step(jp, *dense)
        ref["jax_train_mesh"] = _jax_step(jp, *dense, mesh_tp=2)
        for impl in ("block_fused", "pallas_vjp"):
            ref[f"train_{impl}"] = _port_step(params, dense, dict(TRAIN, attn_impl=impl))
        ref["train_quant_image"] = _port_step(
            params, dense, dict(TRAIN, attach=["c_fc", "c_proj"], image_attn_impl="pallas",
                                quantize_image=True))
        ref["train_pool"] = _port_step(params, (ins["px"], ins["ids"]),
                                       dict(TRAIN, attn_impl="block_fused"), pool=ins["pool"])
        ref["train_dropout"] = _port_step(params, dense, dict(TRAIN, lora_dropout=0.1),
                                          generator=torch.Generator().manual_seed(5))
        # the analyzer, single-device
        from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer

        for wire in ("hwc", "patch"):
            eng = InteriorAnalyzer(params, CFG, training_data=tr.TRAINING, dtype=torch.bfloat16,
                                   quantize=True, max_batch=8, wire_format=wire, device="cpu")
            ref[f"analyzer_{wire}"] = eng.classify_pixels(ins["u8"])
    finally:
        tr.join(procs)
    return d, ref


def _ranks(d, name):
    return [tr.load(d, name, r) for r in range(4)]


def _serving_close(got, want, prefix=""):
    """tests/test_torch_engine.py's serving bars."""
    for k in ("top_idx",):
        np.testing.assert_array_equal(got[prefix + k], want[k])
    for k in ("top_conf", "interior_mass", "non_interior_mass", "topk_vals"):
        np.testing.assert_allclose(got[prefix + k], want[k], atol=1e-3, rtol=0, err_msg=k)


def _lora_close(got, want, grads):
    for k, ref in want.items():
        clear = np.abs(grads[k]) > 1e-3 * np.abs(grads[k]).max()
        np.testing.assert_allclose(got[k][clear], ref[clear], atol=TOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(got[k], ref, atol=2 * 1e-4, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,tp", [(8, None), (8, 4), (1, None), (2, None), (4, 2), (6, 4),
                                  (4, 4), (3, None)])
def test_mesh_shape_factoring(n, tp):
    try:
        ref = jax_mesh_shape_for(n, tp)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            mesh_shape_for(n, tp)
        assert str(ours.value) == str(e)
        return
    assert mesh_shape_for(n, tp) == ref


def test_devices_available():
    """A plain process is a world of one: its mesh is (1, 1) over
    ("data", "model") on a gloo group; a mesh larger than the world is
    refused with JAX's own message."""
    mesh = create_mesh(1, device="cpu")
    assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    assert torch.distributed.get_backend() == "gloo"
    assert mesh_mod.mesh_device(mesh) == torch.device("cpu")
    with pytest.raises(ValueError) as ours:
        create_mesh(2, device="cpu")
    with pytest.raises(ValueError) as ref:
        jax_create_mesh(9)
    assert str(ours.value) == "need 2 devices, have 1"
    assert str(ref.value) == "need 9 devices, have 8"


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    """Two ranks that share a card under nccl are refused before NCCL's
    error, naming backend="gloo"; nothing switches backend on its own."""
    monkeypatch.setattr(mesh_mod.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    inits = []
    monkeypatch.setattr(mesh_mod.dist, "init_process_group", lambda *a, **k: inits.append(a))
    for k, v in (("RANK", "1"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "1"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "29500")):
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match='backend="gloo"'):
        create_mesh(2, device="cuda:0")
    assert not inits


# ---------------------------------------------------------------------------
# The placements
# ---------------------------------------------------------------------------


def _translate(spec):
    """A JAX PartitionSpec as (data, model) placements."""
    out = []
    for axis in ("data", "model"):
        dims = [i for i, s in enumerate(spec) if s == axis]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _skeleton(tree):
    return {k: _skeleton(v) for k, v in tree.items()} if isinstance(tree, dict) else None


def _jax_shapes(name, quantize):
    """The preset's param shapes; quantized (``quantize_model`` reads the
    weights on the host), at its widths with two blocks a tower."""
    from aiic_tpu.ops.quant import quantize_model

    if not quantize:
        return jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), getattr(jax_config, name)))
    p = _unflatten(torch_flatten(tr.seeded_params(name, 3)))
    return quantize_model(jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), p))


@pytest.mark.parametrize("name,quantize", [("TINY_TEST", False), ("VIT_B_16", True),
                                           ("VIT_L_14", False)],
                         ids=["tiny", "vit_b_16_int8", "vit_l_14"])
def test_placement_trees_match_jax(name, quantize):
    """``param_pspecs`` (each replicate option), ``lora_pspecs`` and the
    optimizer-state mapping equal JAX's, translated one entry at a time; at
    tp=4 every sharded axis splits."""
    from jax.sharding import PartitionSpec as P

    from aiic_tpu.adapters import LoRAConfig, init_text_lora as jax_lora

    shapes = _jax_shapes(name, quantize)
    skel = _skeleton(jax.tree.map(lambda _: 0, shapes))
    for kw in ({}, {"replicate_visual": True}, {"replicate_text": True},
               {"replicate_visual": True, "replicate_text": True}):
        ref = jax_sharding.param_pspecs(shapes, **kw)
        ours = param_pspecs(skel, **kw)
        want = jax.tree.map(_translate, ref, is_leaf=lambda x: isinstance(x, P))
        assert ours == want, kw
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        keys = [k.key for k in path]
        spec = jax_sharding.param_pspecs(shapes)
        for k in keys:
            spec = spec[k]
        for i, s in enumerate(spec):
            if s == "model":
                assert leaf.shape[i] % 4 == 0, keys
    cfg = getattr(jax_config, name)
    lora = jax.eval_shape(lambda: jax_lora(jax.random.PRNGKey(1), cfg, LoRAConfig(2, 4)))
    for rep in (False, True):
        want = jax.tree.map(_translate, jax_sharding.lora_pspecs(lora, replicate=rep),
                            is_leaf=lambda x: isinstance(x, P))
        assert lora_pspecs(_skeleton(jax.tree.map(lambda _: 0, lora)), replicate=rep) == want
    # the optimizer state: adapter-shaped moments take the adapters' placements
    from aiic_tpu_torch.parallel.sharding import _opt_state_pspecs

    tl = {p: {ab: torch.zeros(lora[p][ab].shape) for ab in "AB"} for p in lora}
    opt = trainer.AdamW(None, 0, 0).init(tl)
    lspec = lora_pspecs(tl)
    ospec = _opt_state_pspecs(opt, tl, lspec)
    assert ospec["exp_avg"] == lspec and ospec["exp_avg_sq"] == lspec
    assert ospec["step"] == (Replicate(), Replicate())


# ---------------------------------------------------------------------------
# Tensor parallelism: the image encode, the classify program, the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_image_encode_matches_single_device(world4, tp):
    d, ref = world4
    for out in _ranks(d, f"encode_tp{tp}"):
        np.testing.assert_allclose(out["feats"], ref["encode"], atol=TOL, rtol=0)
        np.testing.assert_allclose(out["feats"], ref["jax_encode"], atol=TOL, rtol=0)
        np.testing.assert_allclose(out["feats"], ref["jax_encode_mesh"], atol=TOL, rtol=0)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_train_step_matches_single_device(world4, tp):
    """One step over a (4/tp, tp) mesh, image and text towers
    tensor-parallel: the loss, every adapter gradient (summed over "data"
    once, the model-sharded factors gathered) and the new adapters equal
    the single-device step's, the port's and JAX's (and JAX's own mesh
    step at tp=2); a second step runs."""
    d, ref = world4
    for out in _ranks(d, f"train_tp{tp}"):
        assert str(out["text_impl"]) == "xla"
        for r in (ref["train"], ref["jax_train"], ref["jax_train_mesh"]):
            np.testing.assert_allclose(float(out["loss"]), r["loss"], rtol=TOL)
        for k, g in ref["train"]["grads"].items():
            np.testing.assert_allclose(out["grads/" + k], g, atol=TOL * np.abs(g).max(), rtol=0,
                                       err_msg=k)
        got = {k: out["lora/" + k] for k in ref["train"]["lora"]}
        for r in (ref["train"], ref["jax_train"], ref["jax_train_mesh"]):
            _lora_close(got, r["lora"], ref["train"]["grads"])
        assert np.isfinite(float(out["loss2"]))


def test_grads_flow_only_through_lora():
    """The backbone is untouched by a mesh step by construction; the
    adapters move."""
    mesh = create_mesh(1, device="cpu")
    params = tr.seeded_params("TINY_TEST", 0)
    before = tree_map(lambda t: t.clone(), params)
    tc = trainer.TrainConfig(**TRAIN)
    opt = trainer.make_optimizer(tc, 1)
    ts, _ = trainer.make_train_step(CFG, tc, opt, mesh=mesh)
    lora = _torch_tree(_lora_np())
    rng = np.random.default_rng(0)
    px = torch.from_numpy(rng.standard_normal((4, CFG.image_size, CFG.image_size, 3))
                          .astype(np.float32))
    tok = torch.from_numpy(rng.integers(1, CFG.vocab_size - 1, (4, CFG.context_length)))
    _, new, _ = ts(params, lora, opt.init(lora), px, tok)
    for a, b in zip(torch_flatten(before).values(), torch_flatten(params).values()):
        np.testing.assert_array_equal(a, b)
    assert any(float((new[p][ab].to_local() - lora[p][ab]).abs().max()) > 0
               for p in POINTS for ab in "AB")


def test_sharded_classify_matches_single_device(world4):
    """``make_sharded_classify_fn(kernels=False)`` on (2, 2): the image
    tower tensor-parallel, rows over "data"."""
    d, ref = world4
    for out in _ranks(d, "classify_xla"):
        for key in ("interior_mass", "top_conf", "topk_vals"):
            np.testing.assert_allclose(out[key], ref["classify_xla"][key], atol=TOL, rtol=0)
            np.testing.assert_allclose(out[key], ref["jax_classify_mesh"][key], atol=TOL,
                                       rtol=0)
        np.testing.assert_array_equal(out["top_idx"], ref["jax_classify_mesh"]["top_idx"])


def test_serving_kernels_under_mesh_match_single_device(world4):
    """The int8 + bf16 serving program with every mesh axis as data (each
    rank the single-device program on its two rows, the kernels' plain
    versions here) against the single-device program."""
    d, ref = world4
    for out in _ranks(d, "classify_kernels"):
        _serving_close(out, ref["classify_kernels"])
        np.testing.assert_allclose(out["interior_mass"], ref["classify_kernels"]["interior_mass"],
                                   atol=TOL, rtol=0)


def test_vitb16_serving_kernels_under_mesh(world4):
    """The same at ViT-B/16's widths (two blocks a tower)."""
    d, ref = world4
    for out in _ranks(d, "classify_b16"):
        _serving_close(out, ref["classify_b16"])
        np.testing.assert_allclose(out["topk_vals"], ref["classify_b16"]["topk_vals"],
                                   atol=TOL, rtol=0)


def test_vitb16_tp2_sharded_image_encode(world4):
    """TP at ViT-B/16's widths: the 2304-wide QKV and the 3072-wide MLP split
    over "model"=2."""
    d, ref = world4
    for out in _ranks(d, "encode_b16"):
        np.testing.assert_allclose(out["feats"], ref["VIT_B_16"], atol=WIDE_TOL, rtol=0)


def test_vitl14_tp4_sharded_encode_and_specs(world4):
    """ViT-L/14 (1024 wide, 257 tokens) over "model"=4."""
    d, ref = world4
    for out in _ranks(d, "encode_l14"):
        np.testing.assert_allclose(out["feats"], ref["VIT_L_14"], atol=WIDE_TOL, rtol=0)
        np.testing.assert_allclose(out["feats"], ref["jax_VIT_L_14"], atol=WIDE_TOL, rtol=0)


# ---------------------------------------------------------------------------
# The kernel paths, data-parallel
# ---------------------------------------------------------------------------


def _step_close(out, want):
    np.testing.assert_allclose(float(out["loss"]), want["loss"], rtol=TOL)
    for k, g in want["grads"].items():
        np.testing.assert_allclose(out["grads/" + k], g, atol=TOL * np.abs(g).max(), rtol=0,
                                   err_msg=k)
    _lora_close({k: out["lora/" + k] for k in want["lora"]}, want["lora"], want["grads"])
    assert np.isfinite(float(out["loss2"]))


def test_train_step_mesh_kernels_quantized_matches_single_device(world4):
    """``quantize_image`` under a mesh: the frozen tower's int8 kernels run
    per rank with replicated weights, the text tower tensor-parallel."""
    d, ref = world4
    for out in _ranks(d, "train_quant_image"):
        _step_close(out, ref["train_quant_image"])


@pytest.mark.parametrize("impl", ["block_fused", "pallas_vjp"])
def test_train_step_text_kernels_under_mesh_match_single_device(world4, impl):
    """A kernel text path under a mesh: each rank differentiates the
    single-device text tower on its rows with replicated weights and
    adapters; the global loss on the gathered rows."""
    d, ref = world4
    for out in _ranks(d, f"train_{impl}"):
        assert str(out["text_impl"]) == impl
        _step_close(out, ref[f"train_{impl}"])


def test_train_step_text_kernels_mesh_prompt_pool_pads(world4):
    """A prompt pool of 3 rows on a data axis of 4: padded to 4, the padded
    row never reaches the loss."""
    d, ref = world4
    for out in _ranks(d, "train_pool"):
        _step_close(out, ref["train_pool"])


def test_dropout_under_mesh_matches_single_device(world4):
    """LoRA dropout on the tensor-parallel path: each rank draws the global
    batch's masks from the shared generator and keeps its rows and
    columns."""
    d, ref = world4
    for out in _ranks(d, "train_dropout"):
        _step_close(out, ref["train_dropout"])


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def test_analyzer_with_mesh_matches_single_device(world4):
    """``InteriorAnalyzer(mesh=...)``, int8 serving on (4, 1): 5 rows pad
    to the bucket 8 and each rank classifies 2."""
    d, ref = world4
    for out in _ranks(d, "analyzer_hwc"):
        assert int(out["bucket"]) == 8
        _serving_close(out, ref["analyzer_hwc"], prefix="n5/")
        np.testing.assert_allclose(out["n5/features"], ref["analyzer_hwc"]["features"], atol=TOL,
                                   rtol=0)


def test_analyzer_mesh_patch_wire_matches_single_device(world4):
    """The patch-major uint8 wire on (2, 2): every axis serves data."""
    d, ref = world4
    for out in _ranks(d, "analyzer_patch"):
        assert int(out["bucket"]) == 8
        _serving_close(out, ref["analyzer_patch"], prefix="n5/")
        np.testing.assert_allclose(out["n5/features"], ref["analyzer_patch"]["features"],
                                   atol=TOL, rtol=0)


def test_device_resize_under_mesh_warns_and_falls_back(tmp_path):
    from PIL import Image

    from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer

    eng = InteriorAnalyzer(config=CFG, training_data=tr.TRAINING, max_batch=8, device="cpu",
                           mesh=create_mesh(1, device="cpu"))
    p = tmp_path / "img.jpg"
    Image.new("RGB", (64, 64), (120, 90, 60)).save(p)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = eng.analyze_images_batch([str(p)], device_resize=True)
    assert any("device_resize" in str(x.message) for x in w)
    assert str(p) in res


def test_serving_assembly_under_mesh_matches_single_device():
    """The serving stack (``build_serving_app``: REST, the dynamic batcher,
    pipelined dispatch/fetch) over a mesh-backed engine (a world of one)
    answers /analyze and /analyze-batch as the single-device stack does."""
    import base64
    import io
    import json
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer
    from aiic_tpu_torch.serve.app import build_serving_app
    from aiic_tpu_torch.serve.db import InMemoryDB
    from aiic_tpu_torch.serve.rest import serve_forever_in_thread

    params = tr.seeded_params("TINY_TEST", 0)
    kw = dict(training_data=tr.TRAINING, dtype=torch.bfloat16, quantize=True, max_batch=8,
              device="cpu")
    rng = np.random.default_rng(7)
    payloads = []
    for _ in range(5):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)).save(
            buf, "JPEG", quality=92)
        payloads.append(buf.getvalue())

    def drive(analyzer):
        server, batcher, warmed = build_serving_app(
            analyzer, db=InMemoryDB(), port=0, max_batch=8, max_wait_ms=20.0, pipeline_depth=2,
            warm_buckets=(1, 8), warm_async=False, log=lambda *_: None)
        assert warmed.is_set()
        port = server.server_address[1]
        serve_forever_in_thread(server)
        try:
            def one(body):
                req = urllib.request.Request(f"http://127.0.0.1:{port}/analyze", data=body,
                                             method="POST")
                with urllib.request.urlopen(req, timeout=120) as r:
                    return json.loads(r.read().decode())
            with ThreadPoolExecutor(max_workers=5) as pool:
                singles = list(pool.map(one, payloads))
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/analyze-batch", method="POST",
                data=json.dumps({"images_b64": [base64.b64encode(b).decode()
                                                for b in payloads]}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                batch = json.loads(r.read().decode())["results"]
            return singles, batch
        finally:
            server.shutdown()
            batcher.close()

    ref_singles, ref_batch = drive(InteriorAnalyzer(params, CFG, **kw))
    mesh_singles, mesh_batch = drive(InteriorAnalyzer(params, CFG, mesh=create_mesh(1, device="cpu"),
                                                      **kw))

    def check(a, b):
        assert a["is_interior"] == b["is_interior"]
        assert a["detected_category"] == b["detected_category"]
        np.testing.assert_allclose(a["interior_confidence"], b["interior_confidence"], atol=1e-4)
        for cat in a["analysis"]:
            for (na, pa), (nb, pb) in zip(a["analysis"][cat], b["analysis"][cat]):
                assert na == nb
                np.testing.assert_allclose(pa, pb, atol=1e-4)

    for a, b in zip(ref_singles + ref_batch, mesh_singles + mesh_batch):
        check(a, b)
    for a, b in zip(mesh_singles, mesh_batch):
        check(a, b)


def test_shard_train_step_returns_placed_states():
    """``shard_train_step`` places the states for the layout that
    ``make_train_step`` fixed: DTensors with the placement trees'
    placements, the steps themselves unchanged. A step built without the
    mesh, or a layout other than the step's, is refused."""
    from torch.distributed.tensor import DTensor

    mesh = create_mesh(1, device="cpu")
    params = tr.seeded_params("TINY_TEST", 0)
    tc = trainer.TrainConfig(**TRAIN)
    opt = trainer.make_optimizer(tc, 1)
    ts, es = trainer.make_train_step(CFG, tc, opt, mesh=mesh, device="cpu",
                                     replicate_visual=False)
    lora = _torch_tree(_lora_np())
    jt, je, sp, sl, so = shard_train_step(mesh, ts, es, params, lora, opt.init(lora))
    assert (jt, je) == (ts, es)
    assert ts.layout == {"replicate_visual": False, "replicate_text": False}
    assert isinstance(sp["text"]["blocks"]["attn"]["wqkv"], DTensor)
    assert sp["text"]["blocks"]["attn"]["wqkv"].placements == (Replicate(), Shard(2))
    assert sp["visual"]["blocks"]["mlp"]["w1"].placements == (Replicate(), Shard(2))
    assert sl["c_fc"]["B"].placements == (Replicate(), Shard(2))
    assert so["exp_avg"]["c_proj"]["A"].placements == (Replicate(), Shard(1))
    assert so["step"] == 0 and jt.text_impl == "xla"
    with pytest.raises(ValueError, match="replicate_text=True to make_train_step"):
        shard_train_step(mesh, ts, es, params, lora, opt.init(lora), replicate_text=True)
    single, single_eval = trainer.make_train_step(CFG, tc, opt, device="cpu")
    with pytest.raises(ValueError, match="make_train_step\\(mesh=mesh\\)"):
        shard_train_step(mesh, single, single_eval, params, lora, opt.init(lora))
