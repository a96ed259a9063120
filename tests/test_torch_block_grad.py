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
- form 0 of rows 12 and 14 (the card's route: the backbone products on the
  wgmma stage, the core backward on row 9's passes) composed from the plain
  pieces in its order (the stage's ``dot_t`` and ``chunk_rowscale``, row 9's
  plain core backward with the fp32 store for int8), unchunked, on the
  (2, 2) plan and at the L/14 text width W=768 on its C=6 plan: the plain
  versions' bits, and JAX's kernels at the bars above. The card's launch
  functions refuse an unknown form, fp32's "wmma" and a hidden-axis chunk
  their product cannot take before the library is loaded.
- form 0 of rows 11 and 13 (the forward, also recomputed by rows 12 and 14)
  composed from the plain pieces in its order (the stage's "bias" and "qkv"
  products, the tensor-core core forward's plain version
  ``block_core_fwd_ref``, which normalizes p before p·V, the rank-r
  kernels' plain version ``rank_product_ref``), on the same cases: the
  plain versions' bits, and JAX's ``text_block_fwd`` /
  ``text_block_fwd_int8`` at the bf16 bars above. Form 0's core forward
  refuses an S beyond its one 80-key tile before the library is loaded;
  the plain core takes any S (fp32: within 1e-6 of row 7's plain version,
  which folds 1/l in after p·V). Every chunk of ``text_block_int8_plan``
  over every preset's text tower is whole 128-B stage slices.
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
from aiic_tpu_torch.ops import attention, block_grad, quant

torch.set_num_threads(2)

CFG = config.TINY_TEST
EXACT_BF16 = {"xla_allow_excess_precision": False}
POINTS = ("out_proj", "c_fc", "c_proj")
PLANS = {"unchunked": None, "chunked": (2, 2)}


def _inputs(seed=0, bsz=4, width=None):
    """numpy block params, LoRA factors (nonzero B, at the scale of
    tests/test_block_grad.py), x and a cotangent dy in [-1, 1] at TINY_TEST
    (or at another text width, M = 4 W)."""
    rng = np.random.default_rng(seed)
    s, w, m = CFG.context_length, CFG.text.width, CFG.text.mlp_dim
    if width is not None:
        w, m = width, 4 * width
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


# ---------------------------------------------------------------------------
# Form 0 of rows 12 and 14 (the card's route) composed from the plain pieces
# ---------------------------------------------------------------------------


def _form0_bwd(x, dy, mask, w, heads, scaling, n_chunks=1, eps=1e-5):
    """Rows 12 (bf16) and 14 (int8: ``w`` holds the int8 weights) composed
    from the plain pieces in the order form 0 runs them on the card: the
    forward recomputed, then each backbone cotangent product g·Wᵀ as the
    stage's plain version (``dot_t`` through a bf16 weight as it lies;
    through an int8 one, g·colscale row-quantized per (row, chunk) and
    ``chunk_rowscale``, the chunk sums folded from 0 in order), the rank-r
    term added after it as the epilogues add it, and the core backward as
    row 9's plain version (dqkv stored fp32 for int8, rounded to bf16 by the
    next product's load for bf16)."""
    cdt = x.dtype
    bsz, seq, width = x.shape
    rows = bsz * seq
    t = block_grad._forward(x, block_grad._mask_or_zeros(mask, x), w, heads, scaling, eps)
    dot = lambda a, b: block_grad._dot(a, b, cdt)  # noqa: E731

    def cotangent(g, key, chunks=1):
        if key + "_q" not in w:
            return quant.gemm_stage_ref(g.to(cdt), w[key].to(cdt), "dot_t")
        gs = g * w[block_grad._SCALE[key]]
        q, qs = quant._row_quant(gs.reshape(rows * chunks, -1))
        return quant.gemm_stage_ref(q.reshape(rows, -1), w[key + "_q"].t(), "chunk_rowscale",
                                    row_scale=qs.reshape(rows, chunks), n_chunks=chunks)

    dyf = dy.to(cdt).reshape(rows, width).float()
    t_p = dot(dyf, w["c_proj_B"].t())
    du = cotangent(dyf, "w2") + scaling * dot(t_p, w["c_proj_A"].t())
    f, sig = t["f"], t["sig"]
    dfq = du * (sig + 1.702 * f * sig * (1.0 - sig))
    t_f = dot(dfq, w["c_fc_B"].t())
    dh2 = cotangent(dfq, "w1", n_chunks) + scaling * dot(t_f, w["c_fc_A"].t())
    dy1 = dyf + block_grad._ln_bwd(dh2, t["xhat2"], t["inv2"], w["ln2s"])
    t_o = dot(dy1, w["out_proj_B"].t())
    da = cotangent(dy1, "wo") + scaling * dot(t_o, w["out_proj_A"].t())
    dqkv = attention.fused_attention_qkv_bwd_ref(
        t["qkv"].reshape(bsz, seq, 3 * width), mask, da.reshape(bsz, seq, width), heads=heads,
        out_dtype=torch.float32)
    dh1 = cotangent(dqkv.reshape(rows, 3 * width), "wqkv")
    dx = dy1 + block_grad._ln_bwd(dh1, t["xhat1"], t["inv1"], w["ln1s"])
    dlora = {"out_proj": {"A": scaling * dot(t["a"].t(), t_o),
                          "B": scaling * dot(t["a_ao"].t(), dy1)},
             "c_fc": {"A": scaling * dot(t["h2"].t(), t_f), "B": scaling * dot(t["h2_af"].t(), dfq)},
             "c_proj": {"A": scaling * dot(t["u"].t(), t_p),
                        "B": scaling * dot(t["u_ap"].t(), dyf)}}
    return dx.to(cdt).reshape(x.shape), dlora


# (label, compute dtype, text width (None: TINY_TEST's), int8 plan)
FORM0_CASES = [("bf16", "bfloat16", None, None), ("int8", "int8", None, None),
               ("int8_chunked", "int8", None, (2, 2)), ("int8_W768_C6", "int8", 768, (1, 6))]


@pytest.mark.parametrize("case", FORM0_CASES, ids=[c[0] for c in FORM0_CASES])
def test_form0_composition_matches_plain_and_jax(case):
    """Rows 12 and 14 composed in form 0's order (``_form0_bwd``: the
    stage's plain products, row 9's plain core backward, the fold's plain
    version; at W=768 the L/14 text width on its C=6 plan) give the plain
    versions' bits (the same operations; only the card's fp32 sums run in
    another order), and hold JAX's ``text_block_bwd`` / ``text_block_bwd_int8``
    (interpret mode, excess precision off) at this file's bf16 bars."""
    _, dtype, width, plan = case
    bp, lora, x, dy = _inputs(seed=9, bsz=2, width=width)
    heads = CFG.text.heads if width is None else width // 64
    seq, scaling = CFG.context_length, 2.0
    n_chunks = 1 if plan is None else plan[1]
    xt, dyt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, dy))
    mask = causal_mask(seq)
    kw = dict(heads=heads, scaling=scaling)
    mask_j = jnp.triu(jnp.full((seq, seq), -jnp.inf, jnp.float32), k=1)
    xj, dyj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)
    if dtype == "int8":
        qw_t, qw_j = _quantized(bp)
        w = block_grad._int8_operands(_torch_tree(bp), qw_t, _torch_tree(lora), torch.bfloat16)
        plain = block_grad.text_block_bwd_int8_ref(xt, dyt, mask, _torch_tree(bp), qw_t,
                                                   _torch_tree(lora), n_chunks=n_chunks, **kw)
        run = jax.jit(functools.partial(jax_bg.text_block_bwd_int8, interpret=True,
                                        force_plan=plan, **kw), compiler_options=EXACT_BF16)
        dx_ref, dl_ref = run(xj, dyj, mask_j, _jax_tree(bp), qw_j, _jax_tree(lora))
    else:
        w = block_grad._operands(_torch_tree(bp), _torch_tree(lora), torch.bfloat16)
        plain = block_grad.text_block_bwd_ref(xt, dyt, mask, _torch_tree(bp), _torch_tree(lora),
                                              **kw)
        run = jax.jit(functools.partial(jax_bg.text_block_bwd, interpret=True, **kw),
                      compiler_options=EXACT_BF16)
        dx_ref, dl_ref = run(xj, dyj, mask_j, _jax_tree(bp), _jax_tree(lora))
    dx, dl = _form0_bwd(xt, dyt, mask, w, heads, scaling, n_chunks)
    assert dx.dtype == torch.bfloat16 and dx.shape == xt.shape
    assert torch.equal(dx, plain[0])
    for p in POINTS:
        for ab in "AB":
            assert torch.equal(dl[p][ab], plain[1][p][ab]), (p, ab)
            assert _cos(dl[p][ab].numpy(), np.asarray(dl_ref[p][ab])) >= 0.9999, (p, ab)
    _row_close_bf16(dx.float().numpy(), np.asarray(dx_ref, np.float32))


def _form0_fwd(x, mask, w, heads, scaling, eps=1e-5):
    """Rows 11 (bf16) and 13 (int8: ``w`` holds the int8 weights) composed
    from the plain pieces in the order form 0 runs them on the card: LN1;
    the QKV product as the stage's plain version (bf16 "bias"; int8 the row
    quantizer, then "qkv"); the core forward as the tensor-core kernel's
    plain version (``block_core_fwd_ref``: p normalized before p·V); each
    rank-r down-projection as the rank-r kernels' plain version
    (``rank_product_ref``, rounded where it is stored) ahead of the product
    whose epilogue adds its up-projection; the out-projection with the
    residual; LN2; c_fc with the gelu; c_proj with the residual."""
    cdt = x.dtype
    bsz, seq, width = x.shape
    rows = bsz * seq
    dot = lambda a, b: block_grad._dot(a, b, cdt)  # noqa: E731
    down = lambda a, key: block_grad.rank_product_ref(a, w[key], "down", dtype=cdt)  # noqa: E731
    xf = x.reshape(rows, width).float()
    h1f = block_grad._ln_fwd(xf, w["ln1s"], w["ln1b"], eps)[0]
    if "wqkv_q" in w:
        hq, hs = quant._row_quant(h1f)
        qkv = quant.gemm_stage_ref(hq, w["wqkv_q"], "qkv", row_scale=hs, col_scale=w["sqkv"],
                                   bias=w["bqkv"])
    else:
        qkv = quant.gemm_stage_ref(h1f.to(cdt), w["wqkv"], "bias", bias=w["bqkv"])
    a = block_grad.block_core_fwd_ref(qkv.reshape(bsz, seq, 3 * width), mask, heads)
    a = a.reshape(rows, width)
    y1 = xf + (dot(a, w["wo"]) + w["bo"] + scaling * dot(down(a, "out_proj_A"), w["out_proj_B"]))
    h2f = block_grad._ln_fwd(y1, w["ln2s"], w["ln2b"], eps)[0]
    f = (block_grad._product(h2f, w, "w1", cdt) + w["b1"]
         + scaling * dot(down(h2f.to(cdt), "c_fc_A"), w["c_fc_B"]))
    u = f * torch.sigmoid(1.702 * f)
    mo = (block_grad._product(u, w, "w2", cdt) + w["b2"]
          + scaling * dot(down(u, "c_proj_A"), w["c_proj_B"]))
    return (y1 + mo).to(cdt).reshape(x.shape)


@pytest.mark.parametrize("case", FORM0_CASES, ids=[c[0] for c in FORM0_CASES])
def test_form0_forward_composition_matches_plain_and_jax(case):
    """Rows 11 and 13 composed in form 0's order (``_form0_fwd``: the
    stage's plain products, the tensor-core core forward's and the rank-r
    kernels' plain versions) give the plain versions' bits, and hold JAX's
    ``text_block_fwd`` / ``text_block_fwd_int8`` (interpret mode, excess
    precision off; int8 also on the (2, 2) plan and at W=768 on its C=6
    plan) at this file's bf16 bars."""
    _, dtype, width, plan = case
    bp, lora, x, _ = _inputs(seed=11, bsz=2, width=width)
    heads = CFG.text.heads if width is None else width // 64
    seq, scaling = CFG.context_length, 2.0
    xt = torch.from_numpy(x).to(torch.bfloat16)
    mask = causal_mask(seq)
    kw = dict(heads=heads, scaling=scaling)
    mask_j = jnp.triu(jnp.full((seq, seq), -jnp.inf, jnp.float32), k=1)
    xj = jnp.asarray(x, jnp.bfloat16)
    if dtype == "int8":
        qw_t, qw_j = _quantized(bp)
        w = block_grad._int8_operands(_torch_tree(bp), qw_t, _torch_tree(lora), torch.bfloat16)
        plain = block_grad.text_block_fwd_int8_ref(xt, mask, _torch_tree(bp), qw_t,
                                                   _torch_tree(lora), **kw)
        run = jax.jit(functools.partial(jax_bg.text_block_fwd_int8, interpret=True,
                                        force_plan=plan, **kw), compiler_options=EXACT_BF16)
        y_ref = run(xj, mask_j, _jax_tree(bp), qw_j, _jax_tree(lora))
    else:
        w = block_grad._operands(_torch_tree(bp), _torch_tree(lora), torch.bfloat16)
        plain = block_grad.text_block_fwd_ref(xt, mask, _torch_tree(bp), _torch_tree(lora), **kw)
        run = jax.jit(functools.partial(jax_bg.text_block_fwd, interpret=True, **kw),
                      compiler_options=EXACT_BF16)
        y_ref = run(xj, mask_j, _jax_tree(bp), _jax_tree(lora))
    y = _form0_fwd(xt, mask, w, heads, scaling)
    assert y.dtype == torch.bfloat16 and y.shape == xt.shape
    assert torch.equal(y, plain)
    _row_close_bf16(y.float().numpy(), np.asarray(y_ref, np.float32))


@pytest.mark.parametrize("seq", [81, 128])
def test_plain_core_forward_takes_any_s(seq):
    """The plain core forward takes an S that form 0's one 80-key tile
    cannot: in fp32 within 1e-6 of row 7's plain version (which folds 1/l
    in after p·V, an fp32 rounding apart), in bf16 the shape and dtype."""
    rng = np.random.default_rng(seq)
    qkv = torch.from_numpy(rng.standard_normal((2, seq, 384)).astype(np.float32))
    mask = causal_mask(seq)
    a = block_grad.block_core_fwd_ref(qkv, mask, 2)
    np.testing.assert_allclose(a.numpy(), attention.fused_attention_qkv_ref(qkv, mask, 2).numpy(),
                               atol=1e-6)
    ab = block_grad.block_core_fwd_ref(qkv.bfloat16(), mask, 2)
    assert ab.dtype == torch.bfloat16 and ab.shape == (2, seq, 128)


@pytest.mark.parametrize("kind", ["down", "down_t", "cotangent", "cotangent_t"])
def test_rank_product_plain_version(kind):
    """``rank_product_ref``, the rank-r kernels' plain version: operands
    rounded to the compute dtype, fp32 sums; a down-projection rounded to
    it, a cotangent fp32 and scaled. Held against float64 products of the
    rounded operands."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((91, 64)).astype(np.float32))
    trans = kind.endswith("_t")
    for dtype in (torch.float32, torch.bfloat16):
        ad = a.to(dtype).double()
        if kind.startswith("down"):
            b = torch.from_numpy(rng.standard_normal((4, 64) if trans else (64, 4)).astype(
                np.float32)).to(dtype)
            got = block_grad.rank_product_ref(a, b, "down", dtype=dtype, trans=trans)
            want = ad @ (b.t() if trans else b).double()
            assert got.dtype == dtype
        else:
            b = torch.from_numpy(rng.standard_normal((91, 4)).astype(np.float32)).to(dtype)
            got = block_grad.rank_product_ref(a, b, "cotangent", dtype=dtype, trans=trans,
                                              scaling=2.0)
            want = 2.0 * (ad.t() @ b.double())
            want = want.t() if trans else want
            assert got.dtype == torch.float32
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=tol, atol=tol)


def test_every_text_block_int8_chunk_fills_whole_stage_slices():
    """Each plan that ``text_block_int8_plan`` gives a preset's text tower
    (every batch of 1, 2, 3, 7, 16, 52, 64 and 256) splits the hidden axis
    into chunks of whole 128-B stage slices (``quant.STAGE_SLICE``), which
    form 0's folded dh2 product needs (``_card_chunks`` refuses any other
    before a launch): B/16 and B/32 unchunked (M = 2048), L/14 and
    L/14@336 in six chunks of 512, TINY_TEST unchunked (128)."""
    seen = set()
    for name in ("VIT_B_16", "VIT_B_32", "VIT_L_14", "VIT_L_14_336", "TINY_TEST"):
        c = getattr(config, name)
        t = c.text
        for bsz in (1, 2, 3, 7, 16, 52, 64, 256):
            plan = block_grad.text_block_int8_plan(c.context_length, t.width, t.mlp_dim, t.heads,
                                                   bsz=bsz)
            assert plan is not None, (name, bsz)
            chunk, rest = divmod(t.mlp_dim, plan[1])
            assert rest == 0 and chunk % quant.STAGE_SLICE == 0, (name, bsz, plan)
            block_grad._card_chunks(name, t.mlp_dim, plan[1], "wgmma")
            seen.add(chunk)
    assert seen == {2048, 512, 128}, seen


def _no_library():
    raise AssertionError("the kernel library was reached before the check")


# (label, call on CPU tensors that must be refused, the message's words)
def _refusals():
    bp, lora, x, dy = _inputs(seed=2, bsz=1, width=128)
    bpt, lt = _torch_tree(bp), _torch_tree(lora)
    qw, _ = _quantized(bp)
    xb, dyb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, dy))
    xf, dyf = torch.from_numpy(x), torch.from_numpy(dy)
    mask = causal_mask(CFG.context_length)
    a = (2, 2.0, 1e-5)  # heads (head dim 64), scaling, eps
    i8 = torch.zeros((77, 512), dtype=torch.int8)
    # S = 81: one key past the tensor-core core forward's tile
    x81 = torch.zeros((1, 81, 128), dtype=torch.bfloat16)
    m81 = causal_mask(81)
    return {
        "core_fwd_tile": (lambda: block_grad.block_core_fwd_cuda(
            torch.zeros((1, 81, 384), dtype=torch.bfloat16), m81, 2), "S <= 80"),
        "core_fwd_form": (lambda: block_grad.block_core_fwd_cuda(
            torch.zeros((1, 77, 384), dtype=torch.bfloat16), mask, 2, form="mma"), "form"),
        "bf16_fwd_tile": (lambda: block_grad._text_block_fwd_cuda(x81, m81, bpt, lt, *a),
                          "S <= 80"),
        "bf16_bwd_tile": (lambda: block_grad._text_block_bwd_cuda(x81, x81, m81, bpt, lt, *a),
                          "S <= 80"),
        "int8_fwd_tile": (lambda: block_grad._text_block_fwd_int8_cuda(x81, m81, bpt, qw, lt, *a),
                          "S <= 80"),
        "int8_bwd_tile": (lambda: block_grad._text_block_bwd_int8_cuda(
            x81, x81, m81, bpt, qw, lt, *a, 1), "S <= 80"),
        "rank_product_kind": (lambda: block_grad.rank_product_cuda(xf[0], xf[0], "up"), "kind"),
        "rank_product_form": (lambda: block_grad.rank_product_cuda(xf[0], xf[0], "down",
                                                                   form="simt"), "form"),
        "bf16_fwd_form": (lambda: block_grad._text_block_fwd_cuda(xb, mask, bpt, lt, *a,
                                                                  form="mma"), "form"),
        "bf16_bwd_form": (lambda: block_grad._text_block_bwd_cuda(xb, dyb, mask, bpt, lt, *a,
                                                                  form="tensor"), "form"),
        "fp32_wmma": (lambda: block_grad._text_block_bwd_cuda(xf, dyf, mask, bpt, lt, *a,
                                                              form="wmma"), "one route"),
        "int8_fwd_form": (lambda: block_grad._text_block_fwd_int8_cuda(xb, mask, bpt, qw, lt, *a,
                                                                       form="wgmma2"), "form"),
        "int8_bwd_form": (lambda: block_grad._text_block_bwd_int8_cuda(
            xb, dyb, mask, bpt, qw, lt, *a, 1, form=""), "form"),
        # M = 512 in 8 chunks of 64: not whole 128-B K-slices of the stage's fold
        "int8_chunk_wgmma": (lambda: block_grad._text_block_bwd_int8_cuda(
            xb, dyb, mask, bpt, qw, lt, *a, 8), "multiple of 128"),
        # 32 chunks of 16: not whole 32-deep steps of the WMMA split product
        "int8_chunk_wmma": (lambda: block_grad._text_block_bwd_int8_cuda(
            xb, dyb, mask, bpt, qw, lt, *a, 32, form="wmma"), "multiple of 32"),
        "matmul_form": (lambda: block_grad.int8_matmul_t_cuda(i8, i8, form="stage"), "form"),
    }


REFUSALS = ["bf16_fwd_form", "bf16_bwd_form", "fp32_wmma", "int8_fwd_form", "int8_bwd_form",
            "int8_chunk_wgmma", "int8_chunk_wmma", "matmul_form", "core_fwd_tile",
            "core_fwd_form", "bf16_fwd_tile", "bf16_bwd_tile", "int8_fwd_tile", "int8_bwd_tile",
            "rank_product_kind", "rank_product_form"]


@pytest.mark.parametrize("case", REFUSALS)
def test_card_forms_refuse_before_the_library(monkeypatch, case):
    """The card's launch functions of rows 11-14 take form "wgmma" (the
    route) or "wmma" (the first design; bf16 and int8 only), and a
    hidden-axis chunk that the form's product takes (whole 128-B K-slices
    on the stage, 32-deep steps on the WMMA tile); bf16 and int8 form 0,
    and the core forward alone, S within the tensor-core core forward's one
    80-key tile; the rank-r product alone a known kind and form: anything
    else raises a clear ValueError before the kernel library is built or
    loaded; nothing falls back to another form."""
    monkeypatch.setattr(block_grad, "load_library", _no_library)
    call, words = _refusals()[case]
    with pytest.raises(ValueError, match=words):
        call()

