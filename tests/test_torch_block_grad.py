"""The port's whole-text-block forward and backward against the JAX kernels.

The JAX kernels run as tests/test_block_grad.py runs them on the CPU: Pallas
in interpret mode, unchunked (the TINY_TEST plan) and hidden-axis-chunked
(``force_plan=(2, 2)``). Inputs are made once with numpy and handed to both
packages. Tolerances:

- fp32: forward atol 5e-6, dx and each LoRA cotangent atol 1e-5 (the bars of
  tests/test_block_grad.py; only the order of fp32 sums differs);
- bf16 (the JAX side compiled with ``xla_allow_excess_precision`` off, so
  that XLA rounds every bf16 intermediate as the port does): every row's
  cosine >= 0.9999 or every element within 2 bf16 ULPs, for y and dx; each
  fp32 LoRA cotangent within a cosine of 0.9999 of JAX's.
- int8 (``text_block_{fwd,bwd}_int8`` in interpret mode, the same compiler
  option, weights quantized by the port's ``quantize_weight`` and handed to
  both, the unchunked plan and ``force_plan=(2, 2)``): y and dx under the
  bf16 row bar, each LoRA cotangent within a cosine of 0.9999. The integer
  products are exact in both packages, so the two differ only where an fp32
  sum taken in another order moves an activation across an int8 rounding
  boundary (none did at this size: the outputs are bit-identical).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiic_tpu.ops import block_grad as jax_bg
from aiic_tpu_torch.models import config
from aiic_tpu_torch.models.clip import causal_mask
from aiic_tpu_torch.ops import block_grad, quant

torch.set_num_threads(2)

CFG = config.TINY_TEST
EXACT_BF16 = {"xla_allow_excess_precision": False}
POINTS = ("out_proj", "c_fc", "c_proj")
PLANS = {"unchunked": None, "chunked": (2, 2)}


def _inputs(seed=0, bsz=4):
    """numpy block params, LoRA factors (nonzero B, at the scale of
    tests/test_block_grad.py), x and a cotangent dy in [-1, 1] at TINY_TEST."""
    rng = np.random.default_rng(seed)
    s, w, m = CFG.context_length, CFG.text.width, CFG.text.mlp_dim
    f = lambda *shape, std=1.0: (rng.standard_normal(shape) * std).astype(np.float32)  # noqa: E731
    bp = {
        "ln1": {"scale": 1 + f(w, std=0.1), "bias": f(w, std=0.1)},
        "ln2": {"scale": 1 + f(w, std=0.1), "bias": f(w, std=0.1)},
        "attn": {"wqkv": f(w, 3 * w, std=w ** -0.5), "bqkv": f(3 * w, std=0.1),
                 "wo": f(w, w, std=w ** -0.5), "bo": f(w, std=0.1)},
        "mlp": {"w1": f(w, m, std=w ** -0.5), "b1": f(m, std=0.1),
                "w2": f(m, w, std=m ** -0.5), "b2": f(w, std=0.1)},
    }
    dims = {"out_proj": (w, w), "c_fc": (w, m), "c_proj": (m, w)}
    lora = {p: {"A": f(dims[p][0], 4, std=0.03), "B": f(4, dims[p][1], std=0.02)} for p in POINTS}
    dy = rng.uniform(-1, 1, (bsz, s, w)).astype(np.float32)
    return bp, lora, f(bsz, s, w), dy


def _torch_tree(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def _jax_tree(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _quantized(bp):
    """The port's per-output-channel int8 weights of one block, as torch
    tensors and as JAX arrays (the same values)."""
    qw = {}
    for key, scale, (grp, name) in (("wqkv_q", "sqkv", ("attn", "wqkv")),
                                    ("w1_q", "s1", ("mlp", "w1")), ("w2_q", "s2", ("mlp", "w2"))):
        qw[key], qw[scale] = quant.quantize_weight(torch.from_numpy(bp[grp][name]))
    return qw, {k: jnp.asarray(v.numpy()) for k, v in qw.items()}


def _row_close_bf16(ours: np.ndarray, ref: np.ndarray):
    o, r = ours.reshape(-1, ours.shape[-1]), ref.reshape(-1, ref.shape[-1])
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126))) - 7)
    within = np.abs(o - r) <= 2 * ulp
    cos = (o * r).sum(-1) / (np.linalg.norm(o, axis=-1) * np.linalg.norm(r, axis=-1))
    assert (cos >= 0.9999).all() or within.all(), (cos.min(), within.mean())


def _cos(a, b):
    a, b = a.ravel(), b.ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _run_both(dtype, plan):
    bp, lora, x, dy = _inputs()
    heads, scaling = CFG.text.heads, 2.0
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    seq = CFG.context_length
    kw = dict(heads=heads, scaling=scaling, interpret=True, force_plan=plan)
    mask_j = jnp.triu(jnp.full((seq, seq), -jnp.inf, jnp.float32), k=1)
    fwd = jax.jit(functools.partial(jax_bg.text_block_fwd, **kw), compiler_options=EXACT_BF16)
    bwd = jax.jit(functools.partial(jax_bg.text_block_bwd, **kw), compiler_options=EXACT_BF16)
    xj = jnp.asarray(x, jdt)
    y_ref = np.asarray(fwd(xj, mask_j, _jax_tree(bp), _jax_tree(lora)), np.float32)
    dx_ref, dl_ref = bwd(xj, jnp.asarray(dy, jdt), mask_j, _jax_tree(bp), _jax_tree(lora))

    xt = torch.from_numpy(x).to(tdt)
    mask = causal_mask(seq)
    y = block_grad.text_block_fwd(xt, mask, _torch_tree(bp), _torch_tree(lora), heads=heads,
                                  scaling=scaling)
    dx, dl = block_grad.text_block_bwd(xt, torch.from_numpy(dy).to(tdt), mask, _torch_tree(bp),
                                       _torch_tree(lora), heads=heads, scaling=scaling)
    assert y.dtype == dx.dtype == tdt and y.shape == dx.shape == xt.shape
    assert all(dl[p][ab].dtype == torch.float32 for p in POINTS for ab in "AB")
    return (y.float().numpy(), y_ref, dx.float().numpy(), np.asarray(dx_ref, np.float32),
            dl, dl_ref)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_plain_block_matches_jax_kernels_fp32(plan):
    y, y_ref, dx, dx_ref, dl, dl_ref = _run_both("float32", PLANS[plan])
    np.testing.assert_allclose(y, y_ref, atol=5e-6)
    np.testing.assert_allclose(dx, dx_ref, atol=1e-5)
    for p in POINTS:
        for ab in "AB":
            np.testing.assert_allclose(dl[p][ab].numpy(), np.asarray(dl_ref[p][ab]), atol=1e-5,
                                       err_msg=f"{p}.{ab}")


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_plain_block_matches_jax_kernels_bf16(plan):
    y, y_ref, dx, dx_ref, dl, dl_ref = _run_both("bfloat16", PLANS[plan])
    _row_close_bf16(y, y_ref)
    _row_close_bf16(dx, dx_ref)
    for p in POINTS:
        for ab in "AB":
            assert _cos(dl[p][ab].numpy(), np.asarray(dl_ref[p][ab])) >= 0.9999, (p, ab)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_plain_int8_block_matches_jax_kernels(plan):
    bp, lora, x, dy = _inputs()
    qw_t, qw_j = _quantized(bp)
    heads, seq = CFG.text.heads, CFG.context_length
    kw = dict(heads=heads, scaling=2.0, force_plan=PLANS[plan])
    mask_j = jnp.triu(jnp.full((seq, seq), -jnp.inf, jnp.float32), k=1)
    fwd = jax.jit(functools.partial(jax_bg.text_block_fwd_int8, interpret=True, **kw),
                  compiler_options=EXACT_BF16)
    bwd = jax.jit(functools.partial(jax_bg.text_block_bwd_int8, interpret=True, **kw),
                  compiler_options=EXACT_BF16)
    xj = jnp.asarray(x, jnp.bfloat16)
    y_ref = np.asarray(fwd(xj, mask_j, _jax_tree(bp), qw_j, _jax_tree(lora)), np.float32)
    dx_ref, dl_ref = bwd(xj, jnp.asarray(dy, jnp.bfloat16), mask_j, _jax_tree(bp), qw_j,
                         _jax_tree(lora))

    xt, mask = torch.from_numpy(x).to(torch.bfloat16), causal_mask(seq)
    y = block_grad.text_block_fwd_int8(xt, mask, _torch_tree(bp), qw_t, _torch_tree(lora), **kw)
    dx, dl = block_grad.text_block_bwd_int8(xt, torch.from_numpy(dy).to(torch.bfloat16), mask,
                                            _torch_tree(bp), qw_t, _torch_tree(lora), **kw)
    assert y.dtype == dx.dtype == torch.bfloat16 and y.shape == dx.shape == xt.shape
    _row_close_bf16(y.float().numpy(), y_ref)
    _row_close_bf16(dx.float().numpy(), np.asarray(dx_ref, np.float32))
    for p in POINTS:
        for ab in "AB":
            assert dl[p][ab].dtype == torch.float32
            assert _cos(dl[p][ab].numpy(), np.asarray(dl_ref[p][ab])) >= 0.9999, (p, ab)


def test_plain_int8_plans_differ_only_in_the_dfq_quantization():
    """The chunked plan's forward is the unchunked one; its backward
    quantizes dfq·s1 per (row, chunk), so dx moves, but only within the
    straight-through estimator's noise (the JAX package's own bar, 0.99)."""
    bp, lora, x, dy = _inputs(seed=3)
    qw, _ = _quantized(bp)
    args = (torch.from_numpy(x).to(torch.bfloat16), causal_mask(CFG.context_length),
            _torch_tree(bp), qw, _torch_tree(lora))
    kw = dict(heads=CFG.text.heads, scaling=2.0)
    torch.testing.assert_close(block_grad.text_block_fwd_int8_ref(*args, n_chunks=2, **kw),
                               block_grad.text_block_fwd_int8_ref(*args, **kw), rtol=0, atol=0)
    dyt = torch.from_numpy(dy).to(torch.bfloat16)
    dx1, _ = block_grad.text_block_bwd_int8_ref(args[0], dyt, *args[1:], **kw)
    dx2, _ = block_grad.text_block_bwd_int8_ref(args[0], dyt, *args[1:], n_chunks=2, **kw)
    assert not torch.equal(dx1, dx2)
    assert _cos(dx1.float().numpy(), dx2.float().numpy()) > 0.99


def test_text_block_lora_int8_grads_match_jax_grad():
    """``TextBlockLoRAInt8`` through torch autograd against ``jax.grad``
    through ``text_block_lora_int8`` (interpret mode), on sum(sin(y)) in
    bf16; the int8 weights get no gradient."""
    bp, lora, x, _ = _inputs(seed=1, bsz=2)
    qw_t, qw_j = _quantized(bp)
    heads, scaling, seq = CFG.text.heads, 2.0, CFG.context_length
    mask_j = jnp.triu(jnp.full((seq, seq), -jnp.inf, jnp.float32), k=1)

    def loss_j(x, lora):
        y = jax_bg.text_block_lora_int8(x, _jax_tree(bp), qw_j, lora, mask_j, heads, scaling, True)
        return jnp.sum(jnp.sin(y.astype(jnp.float32)))

    gx_ref, gl_ref = jax.jit(jax.grad(loss_j, argnums=(0, 1)), compiler_options=EXACT_BF16)(
        jnp.asarray(x, jnp.bfloat16), _jax_tree(lora))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    lt = jax.tree.map(lambda t: t.requires_grad_(), _torch_tree(lora))
    y = block_grad.text_block_lora_int8(xt, _torch_tree(bp), qw_t, lt, causal_mask(seq), heads,
                                        scaling)
    torch.sin(y.float()).sum().backward()
    assert not any(t.requires_grad for t in qw_t.values())
    _row_close_bf16(xt.grad.float().numpy(), np.asarray(gx_ref, np.float32))
    for p in POINTS:
        for ab in "AB":
            assert _cos(lt[p][ab].grad.numpy(), np.asarray(gl_ref[p][ab])) >= 0.9999, (p, ab)


def test_text_block_lora_grads_match_jax_grad():
    """``TextBlockLoRA`` through torch autograd against ``jax.grad`` through
    ``text_block_lora`` (interpret mode), on sum(sin(y))."""
    bp, lora, x, _ = _inputs(seed=1, bsz=2)
    heads, scaling, seq = CFG.text.heads, 2.0, CFG.context_length
    mask_j = jnp.triu(jnp.full((seq, seq), -jnp.inf, jnp.float32), k=1)

    def loss_j(x, lora):
        return jnp.sum(jnp.sin(jax_bg.text_block_lora(x, _jax_tree(bp), lora, mask_j, heads,
                                                      scaling, True)))

    gx_ref, gl_ref = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(jnp.asarray(x), _jax_tree(lora))
    xt = torch.from_numpy(x).requires_grad_()
    lt = jax.tree.map(lambda t: t.requires_grad_(), _torch_tree(lora))
    y = block_grad.text_block_lora(xt, _torch_tree(bp), lt, causal_mask(seq), heads, scaling)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_ref), atol=1e-5)
    for p in POINTS:
        for ab in "AB":
            np.testing.assert_allclose(lt[p][ab].grad.numpy(), np.asarray(gl_ref[p][ab]),
                                       atol=1e-5, err_msg=f"{p}.{ab}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["VIT_B_16", "VIT_B_32", "VIT_L_14", "VIT_L_14_336", "TINY_TEST"])
def test_text_block_supported_matches_jax_gate(name, dtype):
    c = getattr(config, name)
    itemsize = 4 if dtype == "float32" else 2
    geom = (c.context_length, c.text.width, c.text.mlp_dim, c.text.heads, itemsize)
    assert block_grad.text_block_supported(*geom) == jax_bg.text_block_supported(*geom)
    assert block_grad.text_block_plan(*geom) == jax_bg.text_block_plan(*geom)


@pytest.mark.parametrize("name", ["VIT_B_16", "VIT_B_32", "VIT_L_14", "VIT_L_14_336", "TINY_TEST"])
def test_text_block_int8_plan_matches_jax_gate(name):
    c = getattr(config, name)
    geom = (c.context_length, c.text.width, c.text.mlp_dim, c.text.heads)
    assert block_grad.text_block_int8_supported(*geom) == jax_bg.text_block_int8_supported(*geom)
    for bsz in (None, 7, 8):
        assert (block_grad.text_block_int8_plan(*geom, bsz=bsz)
                == jax_bg.text_block_int8_plan(*geom, bsz=bsz))


def test_text_block_gate_at_the_cli_geometries():
    """B/16 fp32 plans chunked (2, 8), bf16 unchunked (2, 1); L/14 fp32 has
    no plan (the trainer falls back to pallas_vjp), L/14 bf16 is chunked."""
    assert block_grad.text_block_plan(77, 512, 2048, 8, 4) == (2, 8)
    assert block_grad.text_block_plan(77, 512, 2048, 8, 2) == (2, 1)
    assert block_grad.text_block_plan(77, 768, 3072, 12, 4) is None
    assert block_grad.text_block_plan(77, 768, 3072, 12, 2)[1] > 1
