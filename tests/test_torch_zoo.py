"""The zoo slice of the port (ViT-B/32, ViT-L/14, ViT-L/14@336) against the
JAX package on the CPU.

- The copied VMEM planners equal the JAX ones over a grid of batch sizes,
  every preset's image and text geometry and both item sizes: they fix the
  chunk count of the int8 MLP (its quantization) and the branch each block
  takes.
- The plain versions of the three kernels of this slice (the chunked int8
  MLP, the whole int8 block, the head-grouped core) against the JAX
  kernels in interpret mode or their XLA references, and both large-S
  ladders and the fp32 overflow core with the budgets patched in both
  packages so that each tier runs at a small size.
- A slice: the towers through ``models.clip.block`` at TINY_TEST with the
  budgets patched so that the image tower takes the head-grouped core and
  the chunked MLP and the text tower the whole int8 block, against JAX
  ``attn_impl="pallas"``.

Tolerances: fp32 within 1e-5 (summation order only); bf16 every row's
cosine >= 0.9999 and >= 99% of elements within 2 bf16 ULPs (a rounding flip
at a boundary moves one bf16 value or one int8 step); the chunked int8 MLP
in fp32 at the bar of tests/test_ops.py (max difference within one
quantization level, > 99% of elements within 1e-5). The int8 patch embed is
exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiic_tpu.models import clip as jax_clip
from aiic_tpu.models import config as jax_config
from aiic_tpu.models.clip import causal_mask as jax_causal_mask
from aiic_tpu.models.init import flatten_params, init_clip_params
from aiic_tpu.ops import attention as jax_attention
from aiic_tpu.ops import preprocess as jax_pre
from aiic_tpu.ops import quant as jax_quant
from aiic_tpu_torch.models import clip, config
from aiic_tpu_torch.models.clip import causal_mask
from aiic_tpu_torch.models.init import params_from_numpy
from aiic_tpu_torch.ops import attention, preprocess, quant

torch.set_num_threads(2)

EXACT_BF16 = {"xla_allow_excess_precision": False}
PRESETS = ["VIT_B_16", "VIT_B_32", "VIT_L_14", "VIT_L_14_336"]
BATCHES = (1, 2, 7, 8, 52, 53, 256)


def _close(out, ref, dtype):
    o = out.float().numpy().reshape(-1, out.shape[-1])
    r = np.asarray(jnp.asarray(ref).astype(jnp.float32)).reshape(o.shape)
    if dtype == "float32":
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5)
        return
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126))) - 7)
    assert (np.abs(o - r) <= 2 * ulp).mean() >= 0.99
    cos = (o * r).sum(-1) / (np.linalg.norm(o, axis=-1) * np.linalg.norm(r, axis=-1))
    assert cos.min() >= 0.9999, cos.min()


def _both(a, dtype):
    t, j = torch.from_numpy(np.array(a)), jnp.asarray(a)
    if dtype == "bfloat16":
        return t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return t, j


BUDGETS = {  # budget -> the modules of both packages that read it
    "vmem": ("_VMEM_BUDGET", (quant, jax_quant)),
    "core": ("_CORE_VMEM_BUDGET", (attention, jax_attention)),
    "probs": ("_FALLBACK_PROBS_BUDGET", (attention, jax_attention, jax_quant)),
}


def _patch_budgets(monkeypatch, **values):
    """Set each given budget in both packages."""
    for key, value in values.items():
        if value is not None:
            name, modules = BUDGETS[key]
            for mod in modules:
                monkeypatch.setattr(mod, name, value)


def _spy(monkeypatch, calls, names):
    """Record the calls of the given (module, function) pairs in ``calls``."""
    for mod, name in names:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))


# ---------------------------------------------------------------------------
# The planners
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tower", ["vision", "text"])
@pytest.mark.parametrize("preset", PRESETS)
def test_planners_match_jax(preset, tower):
    cfg = getattr(config, preset)
    t = getattr(cfg, tower)
    seq = cfg.vision_seq_len if tower == "vision" else cfg.context_length
    w, m, h, d = t.width, t.mlp_dim, t.heads, t.head_dim
    assert (quant._VMEM_BUDGET, attention._CORE_VMEM_BUDGET, attention._FALLBACK_PROBS_BUDGET) \
        == (jax_quant._VMEM_BUDGET, jax_attention._CORE_VMEM_BUDGET,
            jax_attention._FALLBACK_PROBS_BUDGET)
    np.testing.assert_array_equal(attention.headmajor_perm(w, h), jax_attention.headmajor_perm(w, h))
    for itemsize in (2, 4):
        assert attention.pick_head_group(seq, h, d, itemsize) == \
            jax_attention.pick_head_group(seq, h, d, itemsize)
        for g in (1, 2):
            for name in ("_attn_vmem_bytes",):
                assert getattr(quant, name)(g, seq, w, itemsize) == \
                    getattr(jax_quant, name)(g, seq, w, itemsize)
            for name in ("_mlp_vmem_bytes", "_block_vmem_bytes"):
                assert getattr(quant, name)(g, seq, w, m, itemsize) == \
                    getattr(jax_quant, name)(g, seq, w, m, itemsize)
            for name in ("qkv_core_vmem_bytes", "ln_attn_vmem_bytes"):
                assert getattr(attention, name)(g, seq, w, itemsize) == \
                    getattr(jax_attention, name)(g, seq, w, itemsize)
            assert attention.qkv_core_fits(seq, w, itemsize, g) == \
                jax_attention.qkv_core_fits(seq, w, itemsize, g)
            for c in (2, 4, 8, 16):
                for name in ("_mlp_chunk_vmem_bytes", "_block_chunk_vmem_bytes"):
                    assert getattr(quant, name)(g, seq, w, m, c, itemsize) == \
                        getattr(jax_quant, name)(g, seq, w, m, c, itemsize)
        for bsz in BATCHES:
            assert quant._mlp_plan(bsz, seq, w, m, itemsize) == \
                jax_quant._mlp_plan(bsz, seq, w, m, itemsize)
            assert quant._block_plan(bsz, seq, w, m, itemsize) == \
                jax_quant._block_plan(bsz, seq, w, m, itemsize)


def test_zoo_plans_are_the_ones_the_slice_names():
    """The plans the zoo's launch counts are built on (chip_smoke.py)."""
    l14, l336, b32 = config.VIT_L_14, config.VIT_L_14_336, config.VIT_B_32
    assert quant._mlp_plan(1, 257, 1024, 4096, 2) == ("chunked", 1, 2)
    assert quant._mlp_plan(8, 257, 1024, 4096, 2) == ("chunked", 2, 4)
    assert all(quant._mlp_plan(b, 577, 1024, 4096, 2) == ("chunked", 1, 4) for b in BATCHES)
    assert quant._block_plan(8, b32.vision_seq_len, 768, 3072, 2) == ("full", 2, 1)
    assert quant._block_plan(1, b32.vision_seq_len, 768, 3072, 2) == ("full", 1, 1)
    assert quant._block_plan(8, l14.vision_seq_len, 1024, 4096, 2) == ("chunked", 1, 16)
    for t in (b32.text, l14.text):  # 52 prompts: every int8 text tower runs row 4
        assert quant._block_plan(52, 77, t.width, t.mlp_dim, 2) == ("full", 2, 1)
    assert attention.qkv_core_fits(257, 1024, 2) and not attention.qkv_core_fits(577, 1024, 2)
    assert attention.pick_head_group(l336.vision_seq_len, 16, 64, 2) == 8
    assert not attention.qkv_core_fits(577, 1024, 4)


# ---------------------------------------------------------------------------
# Row 3: the chunked int8 MLP
# ---------------------------------------------------------------------------


def _mlp_weights(rng, w, m):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    w1_q, s1 = jax_quant.quantize_weight(jnp.asarray(f(w, m) * 0.03))
    w2_q, s2 = jax_quant.quantize_weight(jnp.asarray(f(m, w) * 0.03))
    return [1 + 0.1 * f(w), 0.1 * f(w), np.array(w1_q), np.array(s1), 0.1 * f(m),
            np.array(w2_q), np.array(s2), 0.1 * f(w)]


@pytest.mark.parametrize("n_chunks", [2, 4])
def test_chunked_int8_mlp_plain_matches_jax_rows(n_chunks):
    rng = np.random.default_rng(30)
    b, s, w, m = 4, 64, 128, 512  # 256 rows: a flipped int8 value moves a whole row
    x = (rng.standard_normal((b, s, w)) * 0.1).astype(np.float32)
    x[0, 3] = 0.0  # an all-zero LN row: the 1e-6 scale floor
    p = _mlp_weights(rng, w, m)
    p[1][:] = 0.0
    ref = jax_quant._int8_mlp_rows(
        jnp.asarray(x.reshape(b * s, w)), p[0].reshape(1, w), p[1].reshape(1, w), p[2],
        p[3].reshape(1, m), p[4].reshape(1, m), p[5], p[6].reshape(1, w), p[7].reshape(1, w),
        1e-5, n_chunks=n_chunks).reshape(b, s, w)
    args = [torch.from_numpy(a) for a in [x] + p]
    out = quant.int8_ln_mlp_chunked(*args, n_chunks=n_chunks)
    torch.testing.assert_close(out, quant.int8_ln_mlp_ref(*args, n_chunks=n_chunks),
                               rtol=0, atol=0)
    diff = np.abs(out.numpy() - np.asarray(ref))
    assert diff.max() < 5e-3, diff.max()  # <= one quantization level
    assert (diff > 1e-5).mean() < 0.01
    # the chunking changes the numbers: per-(row, chunk) scales differ from per-row ones
    assert not torch.equal(out, quant.int8_ln_mlp_ref(*args))


# ---------------------------------------------------------------------------
# Row 4: the whole int8 block
# ---------------------------------------------------------------------------


def _block_inputs(rng, b, s, w, dtype):
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    m = 4 * w
    wqkv_q, sqkv = jax_quant.quantize_weight(jnp.asarray(f(w, 3 * w) * w ** -0.5))
    attn = [1 + 0.1 * f(w), 0.1 * f(w), np.array(wqkv_q), np.array(sqkv), 0.1 * f(3 * w),
            f(w, w) * 0.05, 0.1 * f(w)]
    xt, xj = _both(f(b, s, w), dtype)
    return xt, xj, attn, _mlp_weights(rng, w, m)


@pytest.mark.parametrize("plan", [("full", 2, 1), ("chunked", 1, 4)], ids=["full", "chunked"])
def test_int8_block_plain_matches_jax_kernel(plan):
    rng = np.random.default_rng(31)
    b, s, w, h = 2, 16, 64, 4
    xt, xj, attn, mlp = _block_inputs(rng, b, s, w, "bfloat16")
    ref = jax_quant.int8_block(xj, *attn, jax_causal_mask(s), *mlp, heads=h, interpret=True,
                               plan_override=plan)
    targs = [torch.from_numpy(a) for a in attn] + [causal_mask(s)] + \
        [torch.from_numpy(a) for a in mlp]
    out = quant.int8_block(xt, *targs, heads=h, plan_override=plan)
    assert out.dtype == torch.bfloat16 and out.shape == xt.shape
    torch.testing.assert_close(out, quant.int8_block_ref(xt, *targs, heads=h, plan=plan),
                               rtol=0, atol=0)
    _close(out, ref, "bfloat16")
    # the full plan is the pair, bit for bit
    if plan[0] == "full":
        y1 = quant.int8_ln_qkv_attention_ref(xt, *targs[:8], heads=h)
        torch.testing.assert_close(out, quant.int8_ln_mlp_ref(y1, *targs[8:]), rtol=0, atol=0)


@pytest.mark.parametrize("plan", [("full", 2, 1), ("chunked", 1, 2), ("chunked", 2, 4)],
                         ids=["full", "chunked_C2", "chunked_C4"])
def test_int8_block_is_rows_1_then_2_or_3(plan):
    """Row 4 on the CPU is, bit for bit, the public wrappers of row 1 and
    then row 2 (full: ``int8_ln_mlp`` takes its full plan at this size) or
    row 3 (``int8_ln_mlp_chunked`` with the plan's C): the composition its
    card form runs (row 1's form 0, then row 2's or row 3's)."""
    rng = np.random.default_rng(33)
    b, s, w, h = 2, 16, 128, 2
    xt, _, attn, mlp = _block_inputs(rng, b, s, w, "bfloat16")
    targs = [torch.from_numpy(a) for a in attn] + [causal_mask(s)] + \
        [torch.from_numpy(a) for a in mlp]
    out = quant.int8_block(xt, *targs, heads=h, plan_override=plan)
    y1 = quant.int8_ln_qkv_attention(xt, *targs[:8], heads=h)
    if plan[0] == "full":
        assert quant._mlp_plan(b, s, w, 4 * w, 2)[0] == "full"
        want = quant.int8_ln_mlp(y1, *targs[8:])
    else:
        want = quant.int8_ln_mlp_chunked(y1, *targs[8:], n_chunks=plan[2])
    assert torch.equal(out, want)


def test_every_planned_chunk_fills_whole_stage_slices():
    """Each chunked plan that the copied planners reach for a preset's towers
    (bf16 activations, every batch of BATCHES and every bucket up to 256)
    splits 4W into chunks of whole 128-deep K-slices, which the wgmma forms
    of rows 3 and 4 need: L/14 (1, 2), (2, 4), L/14@336 (1, 4), row 4's L/14
    (1, 16)."""
    seen = set()
    for preset in PRESETS:
        cfg = getattr(config, preset)
        for tower, seq in (("vision", cfg.vision_seq_len), ("text", cfg.context_length)):
            t = getattr(cfg, tower)
            for bsz in sorted(set(BATCHES) | {2 ** i for i in range(9)}):
                for plan in (quant._mlp_plan(bsz, seq, t.width, t.mlp_dim, 2),
                             quant._block_plan(bsz, seq, t.width, t.mlp_dim, 2)):
                    if plan is not None and plan[0] == "chunked":
                        assert (t.mlp_dim // plan[2]) % quant.STAGE_SLICE == 0, (preset, plan)
                        seen.add(t.mlp_dim // plan[2])
    assert seen == {2048, 1024, 256}, seen


def test_int8_block_returns_none_without_a_plan(monkeypatch):
    rng = np.random.default_rng(32)
    xt, xj, attn, mlp = _block_inputs(rng, 2, 16, 64, "bfloat16")
    _patch_budgets(monkeypatch, vmem=1)
    assert jax_quant.int8_block(xj, *attn, None, *mlp, heads=4, interpret=True) is None
    targs = [torch.from_numpy(a) for a in attn] + [None] + [torch.from_numpy(a) for a in mlp]
    assert quant.int8_block(xt, *targs, heads=4) is None


# ---------------------------------------------------------------------------
# Row 8: the head-grouped core
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_headgroups_plain_matches_jax_kernel(dtype):
    rng = np.random.default_rng(33)
    b, s, heads, dim = 2, 24, 4, 16
    w = heads * dim
    qt, qj = _both(rng.standard_normal((b, s, 3 * w)).astype(np.float32), dtype)
    ref = jax_attention.fused_attention_qkv_headgroups(qj, jax_causal_mask(s), heads=heads,
                                                       head_group=2, interpret=True)
    out = attention.fused_attention_qkv_headgroups(qt, causal_mask(s), heads=heads, head_group=2)
    assert out.dtype == qt.dtype and out.shape == (b, s, w)
    _close(out, ref, dtype)


def test_headgroups_equal_the_packed_core_under_the_permutation():
    rng = np.random.default_rng(34)
    b, s, heads, dim = 2, 24, 4, 16
    w = heads * dim
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * w)).astype(np.float32)).bfloat16()
    want = attention.fused_attention_qkv_ref(qkv, None, heads)
    hm = qkv[..., torch.from_numpy(attention.headmajor_perm(w, heads)).long()]
    for hg in (1, 2, 4):
        torch.testing.assert_close(attention.fused_attention_qkv_headgroups(
            hm, heads=heads, head_group=hg), want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="head_group"):
        attention.fused_attention_qkv_headgroups(hm, heads=heads, head_group=3)


# ---------------------------------------------------------------------------
# The large-S ladders and the fp32 overflow core
# ---------------------------------------------------------------------------

TIERS = ["all_heads", "head_grouped", "no_head_fits"]


def _tier_budget(tier, s, w, dim, itemsize):
    full = attention.qkv_core_vmem_bytes(1, s, w, itemsize)
    hg2 = attention.qkv_core_vmem_bytes(1, s, 2 * dim, itemsize)
    hg1 = attention.qkv_core_vmem_bytes(1, s, dim, itemsize)
    return {"all_heads": full, "head_grouped": (hg2 + full) // 2, "no_head_fits": hg1 - 1}[tier]


LADDER = ((attention, "fused_attention_qkv"), (attention, "fused_attention_qkv_headgroups"),
          (attention, "_attention_qkv_xla_chunked"), (quant, "_int8_attn_rows_xla"))
WANT_CORE = {"all_heads": "fused_attention_qkv", "head_grouped": "fused_attention_qkv_headgroups"}


@pytest.mark.parametrize("tier", TIERS)
def test_bf16_half_block_large_s_ladder_matches_jax(tier, monkeypatch):
    rng = np.random.default_rng(35)
    b, s, heads, dim = 2, 16, 4, 8
    w = heads * dim
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    x = f(b, s, w) * 0.2
    p = [1 + 0.1 * f(w), 0.1 * f(w), f(w, 3 * w) * 0.1, 0.1 * f(3 * w), f(w, w) * 0.1, 0.1 * f(w)]
    mask = f(s, s) * 0.1
    # the half-block overflows; the core budget picks the tier
    _patch_budgets(monkeypatch, core=_tier_budget(tier, s, w, dim, 4),
                   probs=heads * s * s * 4 if tier == "no_head_fits" else None)
    assert attention.ln_attn_vmem_bytes(1, s, w, 4) > attention._CORE_VMEM_BUDGET
    ref = jax_attention.fused_ln_qkv_attention(jnp.asarray(x), *p, jnp.asarray(mask), heads=heads,
                                               interpret=True)
    calls = []
    _spy(monkeypatch, calls, LADDER)
    out = attention.fused_ln_qkv_attention(torch.from_numpy(x), *map(torch.from_numpy, p),
                                           torch.from_numpy(mask), heads=heads)
    assert calls == [WANT_CORE.get(tier, "_attention_qkv_xla_chunked")]
    _close(out, ref, "float32")


@pytest.mark.parametrize("tier", TIERS)
def test_int8_half_block_large_s_ladder_matches_jax(tier, monkeypatch):
    rng = np.random.default_rng(36)
    b, s, w, heads = 2, 16, 64, 4
    xt, xj, attn, _ = _block_inputs(rng, b, s, w, "bfloat16")
    _patch_budgets(monkeypatch, vmem=1, core=_tier_budget(tier, s, w, w // heads, 2),
                   probs=heads * s * s * 4 if tier == "no_head_fits" else None)
    ref = jax_quant.int8_ln_qkv_attention(xj, *attn, None, heads=heads, interpret=True)
    calls = []
    _spy(monkeypatch, calls, LADDER)
    out = quant.int8_ln_qkv_attention(xt, *map(torch.from_numpy, attn), None, heads=heads)
    assert calls == [WANT_CORE.get(tier, "_int8_attn_rows_xla")]
    _close(out, ref, "bfloat16")


def test_fp32_overflow_core_is_the_chunked_reference(monkeypatch):
    rng = np.random.default_rng(37)
    b, s, heads, dim = 4, 16, 4, 8
    w = heads * dim
    qkv = rng.standard_normal((b, s, 3 * w)).astype(np.float32)
    mask = rng.standard_normal((s, s)).astype(np.float32) * 0.1
    _patch_budgets(monkeypatch, core=1, probs=heads * s * s * 4 * 2)  # two images a chunk
    ref = jax_attention.fused_attention_qkv(jnp.asarray(qkv), jnp.asarray(mask), heads=heads,
                                            interpret=True)
    chunks = []
    monkeypatch.setattr(attention, "attention_qkv_ref",
                        lambda q, *a, _f=attention.attention_qkv_ref: chunks.append(len(q)) or _f(q, *a))
    out = attention.fused_attention_qkv(torch.from_numpy(qkv), torch.from_numpy(mask), heads=heads)
    assert chunks == [2, 2]
    _close(out, ref, "float32")


# ---------------------------------------------------------------------------
# The slice: the towers through models.clip.block on the zoo's routes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jp = init_clip_params(jax.random.PRNGKey(3), jax_config.TINY_TEST)
    return jp, params_from_numpy(flatten_params(jp))


WRAPPERS = ((quant, "int8_block"), (quant, "int8_ln_mlp_chunked"),
            (quant, "int8_ln_qkv_attention"), (quant, "int8_ln_mlp"),
            (attention, "fused_attention_qkv_headgroups"), (attention, "fused_attention_qkv"),
            (attention, "fused_ln_qkv_attention"))


def _zoo_routes(monkeypatch):
    """Budgets under which TINY_TEST's image tower (S=17, W=64) takes the
    large-S attention with the head-grouped core (hg=2) and the chunked
    int8 MLP, and its text tower (S=16, W=32, an even batch) the whole int8
    block on a full plan of two images."""
    _patch_budgets(monkeypatch, vmem=50_000, core=20_000)
    assert quant._block_plan(4, 16, 32, 128, 2) == ("full", 2, 1)
    assert quant._block_plan(2, 17, 64, 256, 2) is None
    assert quant._mlp_plan(2, 17, 64, 256, 2)[0] == "chunked"
    assert attention.pick_head_group(config.TINY_TEST.vision_seq_len, 4, 16, 2) == 2


def _jax_tower(fn, params, x):
    f = jax.jit(functools.partial(fn, config=jax_config.TINY_TEST, dtype=jnp.bfloat16,
                                  attn_impl="pallas"), compiler_options=EXACT_BF16)
    return np.asarray(f(params, jnp.asarray(x)), np.float32)


def _row_cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "bf16"])
def test_slice_towers_on_the_zoo_routes_match_jax(tiny, monkeypatch, quantized):
    jp, tp = tiny
    if quantized:
        jp, tp = jax_quant.quantize_model(jp), quant.quantize_model(tp)
    _zoo_routes(monkeypatch)
    calls = []
    _spy(monkeypatch, calls, WRAPPERS)
    cfg = config.TINY_TEST
    rng = np.random.default_rng(38)
    px = rng.integers(0, 256, (2, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
    if quantized:
        pixels = jax_pre.to_patch_major(px, cfg.patch_size)
    else:
        pixels = np.asarray(jax_pre.normalize_u8(jnp.asarray(px)), np.float32)
    ref = _jax_tower(jax_clip.encode_image, jp, pixels)
    out = clip.encode_image(tp, torch.from_numpy(pixels), cfg, dtype=torch.bfloat16).numpy()
    assert _row_cos(out, ref).min() >= 0.9999
    layers = cfg.vision.layers - 1  # the last block is the CLS-row block
    if quantized:
        assert calls == ["int8_ln_qkv_attention", "fused_attention_qkv_headgroups", "int8_ln_mlp",
                         "int8_ln_mlp_chunked"] * layers
    else:
        assert calls == ["fused_ln_qkv_attention", "fused_attention_qkv_headgroups"] * layers

    calls.clear()
    tok = rng.integers(1, cfg.vocab_size - 2, (4, cfg.context_length)).astype(np.int32)
    tok[:, -1] = cfg.vocab_size - 1
    ref = _jax_tower(jax_clip.encode_text, jp, tok)
    out = clip.encode_text(tp, torch.from_numpy(tok), cfg, dtype=torch.bfloat16).numpy()
    assert _row_cos(out, ref).min() >= 0.9999
    want = ["int8_block"] if quantized else ["fused_ln_qkv_attention", "fused_attention_qkv"]
    assert calls == want * cfg.text.layers


@pytest.mark.parametrize("env", ["0", "1"])
def test_fused_block_env_takes_the_jax_branch(tiny, monkeypatch, env):
    """AIIC_FUSED_BLOCK=0 keeps the pair where the auto rule takes the
    block; =1 takes the block on the plan's best blocking where auto keeps
    the pair (an odd batch: no plan of two images)."""
    jp, tp = tiny
    jq, tq = jax_quant.quantize_model(jp), quant.quantize_model(tp)
    monkeypatch.setenv("AIIC_FUSED_BLOCK", env)
    calls = []
    _spy(monkeypatch, calls, WRAPPERS)
    bsz = 2 if env == "0" else 3
    x = np.random.default_rng(39).standard_normal((bsz, 16, 32)).astype(np.float32)
    layer = jax.tree.map(lambda a: a[0], jq["text"]["blocks"])
    ref = jax.jit(lambda lp, xx: jax_clip.block(xx, lp, 4, jax_causal_mask(16), "quick_gelu",
                                                attn_impl="pallas"), compiler_options=EXACT_BF16)(
        layer, jnp.asarray(x, jnp.bfloat16))
    out = clip.block(torch.from_numpy(x).bfloat16(), clip._layer(tq["text"]["blocks"], 0), 4,
                     causal_mask(16), "quick_gelu", "pallas")
    _close(out, ref, "bfloat16")
    assert calls == (["int8_ln_qkv_attention", "int8_ln_mlp"] if env == "0" else ["int8_block"])


# ---------------------------------------------------------------------------
# The zoo's weights and wire
# ---------------------------------------------------------------------------


def test_params_from_numpy_carries_an_l14_336_tree():
    jcfg = jax_config.VIT_L_14_336
    jcfg = dataclasses.replace(jcfg, vision=dataclasses.replace(jcfg.vision, layers=1),
                               text=dataclasses.replace(jcfg.text, layers=1))
    jp = init_clip_params(jax.random.PRNGKey(4), jcfg)
    flat = flatten_params(jp)
    tp = params_from_numpy(flat)
    assert tuple(tp["visual"]["pos"].shape) == (577, 1024)
    assert tuple(tp["visual"]["patch_embed"].shape) == (3 * 14 * 14, 1024)
    from aiic_tpu_torch.models.init import flatten_params as torch_flatten

    back = torch_flatten(tp)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    tcfg = dataclasses.replace(config.VIT_L_14_336,
                               vision=dataclasses.replace(config.VIT_L_14_336.vision, layers=1))
    px = np.random.default_rng(40).integers(0, 256, (1, 336, 336, 3), dtype=np.uint8)
    pm = jax_pre.to_patch_major(px, 14)
    assert pm.shape == (1, 576, 588)
    ref = np.asarray(jax_clip.encode_image(jp, jnp.asarray(pm), jcfg, dtype=jnp.float32,
                                           attn_impl="xla"))
    out = clip.encode_image(tp, torch.from_numpy(pm), tcfg, dtype=torch.float32,
                            attn_impl="xla").numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pattern", ["all_255", "alternating_columns"])
def test_int8_patch_embed_is_exact_at_b32(pattern):
    """The int8 embed at ViT-B/32 (depth 3·32·32 = 3072, where one fp32
    product of int8 values is not exact) equals JAX's int32 product."""
    rng = np.random.default_rng(41)
    k, w, n = 3 * 32 * 32, 768, 49
    wpe = (rng.standard_normal((k, w)) * 0.02).astype(np.float32)
    # a smoothing filter and a checkerboard one, as a trained embed has: on a
    # saturated patch their sums pass 2^24
    wpe[:, 0] = rng.uniform(0.01, 0.02, k)
    wpe[:, 1] = rng.uniform(0.01, 0.02, k) * (-1.0) ** np.arange(k)
    pixels = np.full((2, n, k), 255, np.uint8)
    if pattern == "alternating_columns":
        pixels[..., ::2] = 0
    pixels[1, :4] = rng.integers(0, 256, (4, k), dtype=np.uint8)
    q = preprocess.quantize_patch_embed(torch.from_numpy(wpe))
    jq = jax_pre.quantize_patch_embed(wpe)
    xs8 = jax.lax.bitcast_convert_type(jnp.asarray(pixels) ^ jnp.uint8(0x80), jnp.int8)
    y = jax.lax.dot_general(xs8, jnp.asarray(jq["wq"]), (((2,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    ref = np.asarray(y.astype(jnp.float32) * jq["wsc"] + jq["c2"])
    out = clip._embed_patch_u8({"patch_embed_q": q}, torch.from_numpy(pixels), config.VIT_B_32,
                               torch.bfloat16)
    np.testing.assert_array_equal(out.numpy(), ref)
