"""The port's LoRA trainer against the JAX package's, on the CPU.

Inputs (backbone weights, adapters, pixels or cached features, tokens) are
made once with numpy and handed to both packages; JAX's Pallas kernels run in
interpret mode. Bars:

- ``contrastive_loss``: rtol 1e-6 (fp32 log-sum-exp, summation order);
- the optimizer against optax over 3 updates, one of which clips: atol 1e-7
  on every parameter and moment (fp32 elementwise math in the same order);
- ``make_train_step`` at TINY_TEST fp32, 2 steps: loss rtol 1e-5 at each
  step; the first Adam moment (0.1 x the clipped gradient) within 1e-4 of
  its largest entry; adapters atol 1e-6 wherever the first gradient is above
  1e-3 of its largest entry, and within Adam's step bound (2 lr per step)
  elsewhere. An Adam step moves an element by about lr whatever the size of
  its gradient, so an element whose gradient lies within fp32 summation
  noise of 0 (about 1e-8 here) may move either way in either package.
- ``train_lora`` end to end: per-epoch losses within 1e-5, the same ``.pth``
  keys and dtypes.
- ``quantize_text`` (the int8 whole-block path in bf16, the JAX side
  compiled with ``xla_allow_excess_precision`` off, both packages' int8
  weights from their own ``quantize_model_mlp``): loss rtol 1e-4 and each
  factor's first Adam moment within a cosine of 0.9999 of JAX's, as the
  text-block tests hold one block (an int8 value that rounds the other way
  moves a whole product row, so the bar is a cosine, not an atol).
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aiic_tpu.models import config as jax_config
from aiic_tpu.models.init import flatten_params, init_clip_params as jax_init
from aiic_tpu.train import trainer as jax_trainer
from aiic_tpu_torch.cli import train_lora as cli
from aiic_tpu_torch.models import config
from aiic_tpu_torch.models.init import params_from_numpy
from aiic_tpu_torch.ops import quant
from aiic_tpu_torch.train import checkpoint, trainer

torch.set_num_threads(2)

CFG = config.TINY_TEST
POINTS = ("out_proj", "c_fc", "c_proj")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lora_np(seed=1, rank=2, b_std=0.02):
    rng = np.random.default_rng(seed)
    w, m, layers = CFG.text.width, CFG.text.mlp_dim, CFG.text.layers
    dims = {"out_proj": (w, w), "c_fc": (w, m), "c_proj": (m, w)}
    return {p: {"A": (rng.standard_normal((layers, dims[p][0], rank)) * 0.02).astype(np.float32),
                "B": (rng.standard_normal((layers, rank, dims[p][1])) * b_std).astype(np.float32)}
            for p in POINTS}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return {p: {ab: torch.from_numpy(np.array(v)) for ab, v in d.items()} for p, d in tree.items()}


@pytest.fixture(scope="module")
def backbone():
    flat = flatten_params(jax_init(jax.random.PRNGKey(0), jax_config.TINY_TEST))
    return jax.tree.map(jnp.asarray, _unflatten(flat)), params_from_numpy(flat)


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    return tree


def test_contrastive_loss_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((6, 8)).astype(np.float32)
    txt = rng.standard_normal((6, 8)).astype(np.float32)
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    scale = np.float32(np.log(1 / 0.07))
    ref = float(jax_trainer.contrastive_loss(jnp.asarray(img), jnp.asarray(txt),
                                             jnp.asarray(scale)))
    ours = float(trainer.contrastive_loss(torch.from_numpy(img), torch.from_numpy(txt),
                                          torch.tensor(scale)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


def test_optimizer_matches_optax_with_clip():
    """Three updates from the same gradients; the second has a global norm
    above 1.0, so the clip engages there; the epoch boundary (2 steps per
    epoch) moves the cosine lr."""
    cfg_j = jax_trainer.TrainConfig(epochs=3, lr=1e-3)
    cfg_t = trainer.TrainConfig(epochs=3, lr=1e-3)
    opt_j = jax_trainer.make_optimizer(cfg_j, steps_per_epoch=2)
    opt_t = trainer.make_optimizer(cfg_t, steps_per_epoch=2)
    params = _lora_np()
    pj, pt = _to_jax(params), _to_torch(params)
    sj, st = opt_j.init(pj), opt_t.init(pt)
    rng = np.random.default_rng(5)
    for i, scale in enumerate((0.01, 3.0, 0.02)):
        grads = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * scale / np.sqrt(a.size)).astype(np.float32),
            params)
        norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                           for g in jax.tree.leaves(grads)))
        assert (norm >= 1.0) == (i == 1), norm
        upd, sj = opt_j.update(_to_jax(grads), sj, pj)
        pj = optax.apply_updates(pj, upd)
        pt, st = opt_t.update(_to_torch(grads), st, pt)
    adam = sj[1][0]
    assert st["step"] == int(adam.count) == 3
    for p in POINTS:
        for ab in "AB":
            np.testing.assert_allclose(pt[p][ab].numpy(), np.asarray(pj[p][ab]), rtol=0,
                                       atol=1e-7, err_msg=f"{p}.{ab}")
            np.testing.assert_allclose(st["exp_avg"][p][ab].numpy(), np.asarray(adam.mu[p][ab]),
                                       rtol=0, atol=1e-7)
            np.testing.assert_allclose(st["exp_avg_sq"][p][ab].numpy(),
                                       np.asarray(adam.nu[p][ab]), rtol=0, atol=1e-7)


def _batch(cached: bool, bsz=4):
    rng = np.random.default_rng(3)
    pool = rng.integers(1, CFG.vocab_size - 2, (3, CFG.context_length)).astype(np.int32)
    pool[:, -1] = CFG.vocab_size - 1
    if cached:
        feats = rng.standard_normal((bsz, CFG.embed_dim)).astype(np.float32)
        feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
        return feats, np.asarray([0, 2, 1, 2], np.int32), pool
    pixels = rng.standard_normal((bsz, CFG.image_size, CFG.image_size, 3)).astype(np.float32)
    tokens = rng.integers(1, CFG.vocab_size - 2, (bsz, CFG.context_length)).astype(np.int32)
    tokens[:, -1] = CFG.vocab_size - 1
    return pixels, tokens, None


@pytest.mark.parametrize("cached", [False, True], ids=["pixels_dense", "cached_pool"])
@pytest.mark.parametrize("impl", ["xla", "pallas_vjp", "block_fused"])
def test_train_step_matches_jax(backbone, impl, cached):
    """Two train steps of ``make_train_step`` on each text path, with the
    feature cache and the prompt pool off (pixels through the frozen image
    tower, dense token rows) and on."""
    params_j, params_t = backbone
    common = dict(epochs=2, batch_size=4, rank=2, alpha=4, attn_impl=impl,
                  image_attn_impl="xla")
    cfg_j, cfg_t = jax_trainer.TrainConfig(**common), trainer.TrainConfig(**common)
    opt_j = jax_trainer.make_optimizer(cfg_j, steps_per_epoch=2)
    opt_t = trainer.make_optimizer(cfg_t, steps_per_epoch=2)
    batch_x, tokens, pool = _batch(cached)
    step_j, _ = jax_trainer.make_train_step(jax_config.TINY_TEST, cfg_j, opt_j,
                                            cached_image=cached, prompt_pool=pool)
    step_t, _ = trainer.make_train_step(CFG, cfg_t, opt_t, cached_image=cached,
                                        prompt_pool=pool, device="cpu")
    assert step_t.text_impl == step_j.text_impl == impl
    lora = _lora_np()
    lj, lt = _to_jax(lora), _to_torch(lora)
    sj, st = opt_j.init(lj), opt_t.init(lt)
    jstep = jax.jit(step_j)
    for i in range(2):
        loss_j, lj, sj = jstep(params_j, lj, sj, jnp.asarray(batch_x), jnp.asarray(tokens),
                               jax.random.PRNGKey(2))
        loss_t, lt, st = step_t(params_t, lt, st, torch.from_numpy(batch_x),
                                torch.from_numpy(tokens))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        if i == 0:
            mu = {p: {ab: np.asarray(sj[1][0].mu[p][ab]) for ab in "AB"} for p in POINTS}
            for p in POINTS:
                for ab in "AB":
                    ref = mu[p][ab]
                    np.testing.assert_allclose(st["exp_avg"][p][ab].numpy(), ref, rtol=0,
                                               atol=1e-4 * np.abs(ref).max(),
                                               err_msg=f"{p}.{ab}")
    for p in POINTS:
        for ab in "AB":
            ours, ref = lt[p][ab].numpy(), np.asarray(lj[p][ab])
            clear = np.abs(mu[p][ab]) > 1e-3 * np.abs(mu[p][ab]).max()
            assert clear.mean() > 0.9
            np.testing.assert_allclose(ours[clear], ref[clear], rtol=0, atol=1e-6,
                                       err_msg=f"{p}.{ab}")
            np.testing.assert_allclose(ours, ref, rtol=0, atol=4 * cfg_t.lr)


@pytest.mark.parametrize("impl", ["pallas_vjp", "block_fused"])
def test_train_step_bf16_matches_jax(backbone, impl):
    """One bf16 train step on each kernel path (cached features, prompt pool),
    the JAX side compiled with ``xla_allow_excess_precision`` off so that it
    rounds every bf16 intermediate as the port does: loss rtol 1e-4 and the
    first Adam moment (the gradient) within cosine 0.9995 per factor (bf16
    roundings flip where fp32 sums differ in order)."""
    params_j, params_t = backbone
    common = dict(epochs=2, batch_size=4, rank=2, alpha=4, attn_impl=impl,
                  image_attn_impl="xla")
    cfg_j = jax_trainer.TrainConfig(dtype=jnp.bfloat16, **common)
    cfg_t = trainer.TrainConfig(dtype=torch.bfloat16, **common)
    opt_j = jax_trainer.make_optimizer(cfg_j, steps_per_epoch=2)
    opt_t = trainer.make_optimizer(cfg_t, steps_per_epoch=2)
    batch_x, tokens, pool = _batch(True)
    step_j, _ = jax_trainer.make_train_step(jax_config.TINY_TEST, cfg_j, opt_j, cached_image=True,
                                            prompt_pool=pool)
    step_t, _ = trainer.make_train_step(CFG, cfg_t, opt_t, cached_image=True, prompt_pool=pool,
                                        device="cpu")
    lora = _lora_np()
    lj, lt = _to_jax(lora), _to_torch(lora)
    loss_j, _, sj = jax.jit(step_j, compiler_options={"xla_allow_excess_precision": False})(
        params_j, lj, opt_j.init(lj), jnp.asarray(batch_x), jnp.asarray(tokens),
        jax.random.PRNGKey(2))
    loss_t, _, st = step_t(params_t, lt, opt_t.init(lt), torch.from_numpy(batch_x),
                           torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    for p in POINTS:
        for ab in "AB":
            a = st["exp_avg"][p][ab].numpy().ravel()
            b = np.asarray(sj[1][0].mu[p][ab]).ravel()
            assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.9995, (p, ab)


def test_quantized_image_features_match_jax(backbone):
    """``quantize_image``: the frozen tower on the int8 serving kernels (their
    plain versions here; JAX's in interpret mode), bf16, as each package's
    trainer quantizes it; feature rows within cosine 0.9999, the bar of the
    int8 serving tests."""
    from aiic_tpu.ops.quant import quantize_model_mlp

    params_j, params_t = backbone
    common = dict(quantize_image=True, image_attn_impl="pallas")
    cfg_j, cfg_t = jax_trainer.TrainConfig(**common), trainer.TrainConfig(**common)
    step_j, _ = jax_trainer.make_train_step(jax_config.TINY_TEST, cfg_j,
                                            jax_trainer.make_optimizer(cfg_j, 1))
    step_t, _ = trainer.make_train_step(CFG, cfg_t, trainer.make_optimizer(cfg_t, 1),
                                        device="cpu")
    pixels, _, _ = _batch(False)
    ref = np.asarray(jax.jit(step_j.image_features)(
        quantize_model_mlp(params_j, attn=True, towers=("visual",)), jnp.asarray(pixels)))
    quantized = quant.quantize_model_mlp(params_t, attn=True, towers=("visual",))
    assert "attn_q" in quantized["visual"]["blocks"] and "attn_q" not in quantized["text"]["blocks"]
    ours = step_t.image_features(quantized, torch.from_numpy(pixels)).numpy()
    assert ours.dtype == ref.dtype == np.float32
    cos = (ours * ref).sum(-1) / (np.linalg.norm(ours, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= 0.9999, cos


def test_quantize_text_and_mesh_are_refused(backbone):
    """``quantize_text`` off the ``block_fused`` path raises JAX's error in
    both packages (the port's old "not ported" text is gone). A mesh is no
    longer refused: two steps of ``make_train_step(mesh=...)`` on a mesh of
    one (the mesh path's row slices, gathers and gradient sum) give JAX's
    losses and first moments, the bars of ``test_train_step_matches_jax``."""
    from aiic_tpu_torch.parallel import create_mesh

    cfg = trainer.TrainConfig(quantize_text=True, attn_impl="xla")
    opt = trainer.make_optimizer(cfg, 1)
    with pytest.raises(ValueError, match="quantize_text requires") as ours:
        trainer.make_train_step(CFG, cfg, opt, device="cpu")
    with pytest.raises(ValueError, match="quantize_text requires") as ref:
        jax_trainer.make_train_step(jax_config.TINY_TEST, jax_trainer.TrainConfig(
            quantize_text=True, attn_impl="xla"), jax_trainer.make_optimizer(cfg, 1))
    assert str(ours.value) == str(ref.value)
    assert "not ported" not in str(ours.value) and "ROADMAP" not in str(ours.value)

    params_j, params_t = backbone
    common = dict(epochs=2, batch_size=4, rank=2, alpha=4, attn_impl="xla",
                  image_attn_impl="xla")
    cfg_j, cfg_t = jax_trainer.TrainConfig(**common), trainer.TrainConfig(**common)
    opt_j = jax_trainer.make_optimizer(cfg_j, steps_per_epoch=2)
    opt_t = trainer.make_optimizer(cfg_t, steps_per_epoch=2)
    step_j, _ = jax_trainer.make_train_step(jax_config.TINY_TEST, cfg_j, opt_j)
    step_t, _ = trainer.make_train_step(CFG, cfg_t, opt_t, mesh=create_mesh(1, device="cpu"))
    pixels, tokens, _ = _batch(False)
    lj, lt = _to_jax(_lora_np()), _to_torch(_lora_np())
    sj, st = opt_j.init(lj), opt_t.init(lt)
    for _ in range(2):
        loss_j, lj, sj = jax.jit(step_j)(params_j, lj, sj, jnp.asarray(pixels),
                                         jnp.asarray(tokens), jax.random.PRNGKey(2))
        loss_t, lt, st = step_t(params_t, lt, st, torch.from_numpy(pixels),
                                torch.from_numpy(tokens))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    mu = sj[1][0].mu
    for p in POINTS:
        for ab in "AB":
            ref = np.asarray(mu[p][ab])
            np.testing.assert_allclose(st["exp_avg"][p][ab].to_local().numpy(), ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max(), err_msg=f"{p}.{ab}")


def test_train_step_quantize_text_matches_jax(backbone):
    """``quantize_text`` with ``block_fused``: the step resolves to the int8
    whole-block path in both packages and one step agrees (cached features,
    the prompt pool)."""
    from aiic_tpu.ops.quant import quantize_model_mlp as jax_quantize

    params_j, params_t = backbone
    common = dict(epochs=2, batch_size=4, rank=2, alpha=4, attn_impl="block_fused",
                  quantize_text=True, image_attn_impl="xla")
    cfg_j, cfg_t = jax_trainer.TrainConfig(**common), trainer.TrainConfig(**common)
    opt_j = jax_trainer.make_optimizer(cfg_j, steps_per_epoch=2)
    opt_t = trainer.make_optimizer(cfg_t, steps_per_epoch=2)
    batch_x, tokens, pool = _batch(True)
    step_j, _ = jax_trainer.make_train_step(jax_config.TINY_TEST, cfg_j, opt_j, cached_image=True,
                                            prompt_pool=pool)
    step_t, eval_t = trainer.make_train_step(CFG, cfg_t, opt_t, cached_image=True,
                                             prompt_pool=pool, device="cpu")
    assert step_t.text_impl == eval_t.text_impl == step_j.text_impl == "block_fused_int8"
    qp_j = jax_quantize(params_j, attn=True, towers=("text",))
    qp_t = quant.quantize_model_mlp(params_t, attn=True, towers=("text",))
    np.testing.assert_array_equal(qp_t["text"]["blocks"]["mlp_q"]["w1_q"].numpy(),
                                  np.asarray(qp_j["text"]["blocks"]["mlp_q"]["w1_q"]))
    lora = _lora_np()
    lj, lt = _to_jax(lora), _to_torch(lora)
    loss_j, _, sj = jax.jit(step_j, compiler_options={"xla_allow_excess_precision": False})(
        qp_j, lj, opt_j.init(lj), jnp.asarray(batch_x), jnp.asarray(tokens),
        jax.random.PRNGKey(2))
    loss_t, new_t, st = step_t(qp_t, lt, opt_t.init(lt), torch.from_numpy(batch_x),
                               torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    for p in POINTS:
        for ab in "AB":
            a = st["exp_avg"][p][ab].numpy().ravel()
            b = np.asarray(sj[1][0].mu[p][ab]).ravel()
            assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.9999, (p, ab)
            assert new_t[p][ab].dtype == torch.float32


def test_block_fused_int8_without_int8_weights_is_block_fused(backbone):
    """``block(..., attn_impl="block_fused_int8")`` on a tree without
    ``attn_q``/``mlp_q`` runs the bf16 whole-block path, as JAX's block does
    (tests/test_block_grad.py::test_block_fused_int8_routing_falls_back_without_qweights);
    with them, the int8 kernels' plain versions."""
    from aiic_tpu_torch.models.clip import _layer, block, causal_mask
    from aiic_tpu_torch.ops import _build

    _, params = backbone
    bp = _layer(params["text"]["blocks"], 0)
    lora = _layer(_to_torch(_lora_np()), 0)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, CFG.context_length, CFG.text.width)).astype(np.float32)).to(torch.bfloat16)
    mask = causal_mask(CFG.context_length)
    kw = dict(lora=lora, lora_scaling=2.0)
    a = block(x, bp, CFG.text.heads, mask, "quick_gelu", "block_fused", **kw)
    b = block(x, bp, CFG.text.heads, mask, "quick_gelu", "block_fused_int8", **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    qbp = _layer(quant.quantize_model_mlp(params, attn=True, towers=("text",))["text"]["blocks"], 0)
    c = block(x, qbp, CFG.text.heads, mask, "quick_gelu", "block_fused_int8", **kw)
    assert not torch.equal(a, c)
    assert _build.launch_counts()["text_block_fwd_int8"] == 0  # the CPU runs the plain version


def test_cli_trains_with_quantize_text(synth_dataset, tmp_path, capsys):
    """``train_lora --attn-impl block_fused --quantize-text`` end to end on
    the CPU: the int8 path trains and writes the reference ``.pth``."""
    json_path, root = synth_dataset
    save = str(tmp_path / "q.pth")
    argv = ["--json-path", json_path, "--image-root", root, "--save-path", save, "--epochs", "1",
            "--batch-size", "8", "--rank", "2", "--alpha", "4", "--model", "tiny",
            "--attn-impl", "block_fused", "--quantize-text", "--quantize-image",
            "--device", "cpu"]
    assert cli.main(argv) == 0
    assert "best val loss" in capsys.readouterr().out
    sd = torch.load(save, map_location="cpu", weights_only=True)
    assert len(sd) == 6 * CFG.text.layers and all(v.dtype == torch.float32 for v in sd.values())


def test_remat_and_dropout(backbone):
    """``remat`` recomputes each block without changing the gradient; LoRA
    dropout keeps a 1 - p share of the delta, scaled by 1 / (1 - p), and a
    recomputed block draws the same masks (compared by statistics: the port's
    generator is not JAX's)."""
    from aiic_tpu_torch.models.clip import _maybe_lora_linear, encode_text

    _, params = backbone
    tokens = torch.from_numpy(_batch(False)[1])
    grads = []
    for remat in (False, True):
        lora = {p: {ab: t.requires_grad_() for ab, t in d.items()}
                for p, d in _to_torch(_lora_np()).items()}
        out = encode_text(params, tokens, CFG, attn_impl="pallas_vjp", lora=lora,
                          lora_scaling=2.0, remat=remat, lora_dropout=0.3,
                          lora_generator=torch.Generator().manual_seed(7))
        out.square().sum().backward()
        grads.append([lora[p][ab].grad for p in POINTS for ab in "AB"])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)

    x = torch.ones(64, 64)
    lora = {"A": torch.eye(64)[:, :32], "B": torch.ones(32, 64)}
    w = torch.zeros(64, 64)
    y = _maybe_lora_linear(x, w, None, lora, 1.0, dropout=0.25,
                           generator=torch.Generator().manual_seed(0))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.02
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 32 / 0.75))


@pytest.fixture(scope="module")
def synth_dataset(tmp_path_factory):
    """tests/test_train.py's synthetic dataset: 24 random 40x40 PNGs."""
    from PIL import Image

    root = tmp_path_factory.mktemp("ds")
    rng = np.random.default_rng(0)
    items = []
    styles = ["nowoczesny", "klasyczny", "boho"]
    rooms = ["kuchnia", "salon", ""]
    for i in range(24):
        name = f"img{i}.png"
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)).save(root / name)
        items.append({
            "image_path": name,
            "style": styles[i % 3],
            "characteristics": ["przestronne", "jasne"][: (i % 3)],
            "materials": ["drewno"],
            "colors": ["biały"],
            "room_type": rooms[i % 3],
        })
    path = root / "dataset.json"
    path.write_text(json.dumps({"training_data": items}), encoding="utf-8")
    return str(path), str(root)


def test_train_lora_matches_jax(backbone, synth_dataset, tmp_path, monkeypatch):
    """Two epochs of ``train_lora`` in both packages from the same backbone
    and the same initial adapters: the same data order, prompts and losses,
    and the same ``.pth`` layout."""
    params_j, params_t = backbone
    json_path, root = synth_dataset
    lora = _lora_np(b_std=0.0)
    monkeypatch.setattr(jax_trainer, "init_text_lora", lambda *a, **k: _to_jax(lora))
    monkeypatch.setattr(trainer, "init_text_lora", lambda *a, **k: _to_torch(lora))
    common = dict(epochs=2, batch_size=8, rank=2, alpha=4, seed=0)
    out_j = jax_trainer.train_lora(json_path, str(tmp_path / "j.pth"), params=params_j,
                                   config=jax_config.TINY_TEST,
                                   cfg=jax_trainer.TrainConfig(**common), image_root=root,
                                   log=lambda *_: None)
    out_t = trainer.train_lora(json_path, str(tmp_path / "t.pth"), params=params_t, config=CFG,
                               cfg=trainer.TrainConfig(**common), image_root=root,
                               log=lambda *_: None, device="cpu")
    assert len(out_t["history"]) == len(out_j["history"]) == 2
    for ht, hj in zip(out_t["history"], out_j["history"]):
        assert ht["epoch"] == hj["epoch"]
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(ht[k], hj[k], rtol=0, atol=1e-5)
    assert float(out_t["lora_tree"]["c_fc"]["B"].abs().max()) > 0
    sd_t = torch.load(str(tmp_path / "t.pth"), map_location="cpu", weights_only=True)
    sd_j = torch.load(str(tmp_path / "j.pth"), map_location="cpu", weights_only=True)
    assert list(sd_t) == list(sd_j)
    assert all(sd_t[k].dtype == sd_j[k].dtype == torch.float32 for k in sd_t)
    with np.load(str(tmp_path / "t.pth.npz")) as a, np.load(str(tmp_path / "j.pth.npz")) as b:
        assert sorted(a.files) == sorted(b.files)


def test_trained_lora_evaluation_matches_jax(backbone, synth_dataset, tmp_path):
    """``--test``: in-batch retrieval accuracy of one saved adapter, the same
    in both packages (the same prompts drawn, the same similarity argmax)."""
    from aiic_tpu.train.evaluate import test_trained_lora as jax_eval
    from aiic_tpu_torch.adapters import save_lora_pth
    from aiic_tpu_torch.train.evaluate import test_trained_lora as torch_eval

    params_j, params_t = backbone
    json_path, root = synth_dataset
    path = str(tmp_path / "a.pth")
    save_lora_pth(_to_torch(_lora_np(rank=16, b_std=0.05)), path)
    kw = dict(config=CFG, rank=16, alpha=32, batch_size=8, image_root=root)
    ours = torch_eval(json_path, path, params=params_t, device="cpu", **kw)
    ref = jax_eval(json_path, path, params=params_j, **dict(kw, config=jax_config.TINY_TEST))
    assert ours == ref and 0.0 <= ours <= 1.0


class _Stop(Exception):
    pass


def test_resume_replays_the_uninterrupted_run(backbone, synth_dataset, tmp_path):
    """A run stopped after its first epoch's state was saved and then resumed
    gives the uninterrupted run's later epochs and final adapters."""
    _, params = backbone
    json_path, root = synth_dataset
    cfg = trainer.TrainConfig(epochs=3, batch_size=8, rank=2, alpha=4, seed=0,
                              attn_impl="pallas_vjp")
    full = trainer.train_lora(json_path, str(tmp_path / "a.pth"), params=params, config=CFG,
                              cfg=cfg, image_root=root, log=lambda *_: None, device="cpu")

    def stop_in_epoch_2(msg):
        if msg.startswith("epoch 2/"):
            raise _Stop

    save = str(tmp_path / "b.pth")
    with pytest.raises(_Stop):
        trainer.train_lora(json_path, save, params=params, config=CFG, cfg=cfg, image_root=root,
                           log=stop_in_epoch_2, device="cpu")
    with np.load(save + ".state.npz") as blob:
        meta = json.loads(bytes(blob["meta"].tobytes()).decode())
    assert meta["epoch"] == 0 and meta["step"] == 2
    resumed = trainer.train_lora(json_path, save, params=params, config=CFG, cfg=cfg,
                                 image_root=root, log=lambda *_: None, resume=True,
                                 device="cpu")
    assert [h["epoch"] for h in resumed["history"]] == [2, 3]
    for hr, hf in zip(resumed["history"], full["history"][1:]):
        for k in ("train_loss", "val_loss"):
            assert hr[k] == hf[k]
    lora, opt_state, _ = checkpoint.load_train_state(save + ".state.npz", resumed["lora_tree"],
                                                     trainer.AdamW(None, 0, 0).init(
                                                         resumed["lora_tree"]), device="cpu")
    assert opt_state["step"] == 6
    for p in POINTS:
        for ab in "AB":
            torch.testing.assert_close(resumed["lora_tree"][p][ab], full["lora_tree"][p][ab],
                                       rtol=0, atol=0)


def test_cli_parses_the_jax_cli_flags(backbone, synth_dataset, tmp_path, monkeypatch, capsys):
    """Every flag of ``aiic_tpu/cli/train_lora.py`` parses here with the same
    default; ``--device`` is the port's own. ``--quantize-text`` is ported
    (it passes through to ``TrainConfig``). ``--mesh 1 --tp 1`` trains over a
    mesh of one: its best val loss is JAX's ``train_lora`` over JAX's mesh
    of one device, from the same weights and adapters."""
    src = open(os.path.join(REPO, "aiic_tpu", "cli", "train_lora.py"), encoding="utf-8").read()
    jax_flags = re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"', src)
    ours = {a.option_strings[0]: a for a in cli.build_parser()._actions if a.option_strings
            and a.option_strings[0] != "-h"}
    assert set(ours) == set(jax_flags) | {"--device"}
    assert ours["--device"].default == "cuda"
    for flag, default in [("--epochs", 20), ("--batch-size", 8), ("--rank", 16), ("--alpha", 32),
                          ("--lr", 1e-4), ("--dtype", "float32"), ("--attn-impl", "auto"),
                          ("--model", "vit_b_16"), ("--mesh", 0)]:
        assert ours[flag].default == default, flag
    assert cli.build_parser().parse_args(["--quantize-text"]).quantize_text

    from aiic_tpu.models.init import save_clip_weights
    from aiic_tpu.parallel import create_mesh as jax_create_mesh

    params_j, _ = backbone
    json_path, root = synth_dataset
    weights = str(tmp_path / "w.npz")
    save_clip_weights(params_j, weights)
    lora = _lora_np(b_std=0.0)
    monkeypatch.setattr(jax_trainer, "init_text_lora", lambda *a, **k: _to_jax(lora))
    monkeypatch.setattr(trainer, "init_text_lora", lambda *a, **k: _to_torch(lora))
    argv = ["--json-path", json_path, "--image-root", root, "--save-path",
            str(tmp_path / "m.pth"), "--epochs", "1", "--batch-size", "8", "--rank", "2",
            "--alpha", "4", "--model", "tiny", "--weights", weights, "--device", "cpu",
            "--mesh", "1", "--tp", "1"]
    capsys.readouterr()
    assert cli.main(argv) == 0
    printed = capsys.readouterr().out
    ref = jax_trainer.train_lora(json_path, str(tmp_path / "j.pth"), params=params_j,
                                 config=jax_config.TINY_TEST,
                                 cfg=jax_trainer.TrainConfig(epochs=1, batch_size=8, rank=2,
                                                             alpha=4),
                                 image_root=root, mesh=jax_create_mesh(1, tp=1),
                                 log=lambda *_: None)
    assert f"best val loss: {ref['best_val_loss']:.4f}" in printed
    assert os.path.exists(str(tmp_path / "m.pth"))
