"""The plain versions of the kernel-experiment variants against the tools'
own Pallas bodies.

The nested defs of each tool's ``main()`` (``tools/kernel_experiments{,2,3,
4,5,7}.py``, left unchanged) are taken out with ``ast`` and run with the
names ``main()`` binds, ``pl.pallas_call`` in interpret mode, on the CPU, the
JAX side compiled with ``xla_allow_excess_precision`` off and XLA's
algebraic simplifier off (``EXACT_BF16``). Weights:
``init_clip_params`` at a two-layer W=128, H=2 vision tower in bf16, with
seeded biases and LN scales (the LN bias stays 0, so an all-zero x row gives
an all-zero LN row), carried to the port with ``params_from_numpy`` and
quantized on each side. Each layer runs on the same x.

Bars (tests/test_torch_quant.py's): every row's cosine >= 0.9999 and >= 99%
of the elements within 1 bf16 ULP, since an fp32 sum in another order can
move a bf16 rounding or an int8 quantization step; the two ``maconly``
ablations exact (integer products and one fp32 add); the three 16d
schedules' core bit for bit the port's row 1 plain core (the 1e-38 guard
never acts on these scores).
"""

import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from aiic_tpu.models import CLIPConfig, TowerConfig
from aiic_tpu.models.init import flatten_params, init_clip_params as jax_init
from aiic_tpu.ops import quant as jax_quant
from aiic_tpu_torch.models.init import params_from_numpy, tree_map
from aiic_tpu_torch.ops import _build, attention, quant
from aiic_tpu_torch.probes import kernel_experiments, variants

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bf16 rounded where the bodies round it; "algsimp" off so that XLA keeps
# each ``amax / 127.0`` a division, as the bodies write it (the simplifier
# turns a division by a constant into a product with its rounded reciprocal,
# which moves int8 roundings of bf16 values that sit on a tie).
EXACT_BF16 = {"xla_allow_excess_precision": False, "xla_disable_hlo_passes": "algsimp"}
WIDTH, HEADS, SEQ = 128, 2, 17
CONFIG = CLIPConfig(name="two-layer", image_size=64, patch_size=16,
                    vision=TowerConfig(width=WIDTH, layers=2, heads=HEADS),
                    text=TowerConfig(width=64, layers=1, heads=1), vocab_size=64,
                    context_length=8, embed_dim=32)
TOOL = {w: f"tools/kernel_experiments{n}.py" for w, n in (
    ("int8_attn_nomax", ""), ("mlp_var", ""), ("attn_var2", "2"), ("mlp_var3", "3"),
    ("attn_var4", "4"), ("attn_var5", "5"), ("attn_var7", "7"))}
CASES = [(w, v) for w, vs in variants.WRAPPER_VARIANTS.items() for v in vs]
_NESTED = {"make_kernel", "attn_var", "mlp_var", "_nomax_kernel", "_mlp_kernel_var",
           "int8_attn_nomax", "core_bf16", "core_int8"}


class _InterpretPallas:
    BlockSpec = pl.BlockSpec
    pallas_call = functools.partial(pl.pallas_call, interpret=True)


@functools.lru_cache(maxsize=None)
def _tool(path):
    """The tool's nested defs of main(), bound to the names main() binds."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    defs = [n for n in main.body if isinstance(n, ast.FunctionDef) and n.name in _NESTED]
    ns = dict(jax=jax, jnp=jnp, pl=_InterpretPallas, pltpu=pltpu, functools=functools,
              LOG2E=variants.LOG2E, H=HEADS, M=4 * WIDTH, _row_quant=jax_quant._row_quant,
              quantize_weight=jax_quant.quantize_weight)
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def layers():
    """(JAX per-layer trees as the tools index them, the port's layer_params)."""
    flat = flatten_params(jax_init(jax.random.PRNGKey(0), CONFIG))
    rng = np.random.default_rng(7)
    for key in ("attn/bqkv", "attn/bo", "mlp/b1", "mlp/b2"):
        k = "visual/blocks/" + key
        flat[k] = (0.1 * rng.standard_normal(flat[k].shape)).astype(np.float32)
    for key in ("ln1/scale", "ln2/scale"):
        k = "visual/blocks/" + key
        flat[k] = (1 + 0.1 * rng.standard_normal(flat[k].shape)).astype(np.float32)
    jtree = {}
    for key, value in flat.items():
        node = jtree
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(value, jnp.bfloat16)
    jblocks = dict(jax_quant.quantize_model(jtree)["visual"]["blocks"])
    jblocks["attn_bf16"] = {"wqkv": jblocks["attn"]["wqkv"], "wo": jblocks["attn"]["wo"]}
    jblocks["mlp_bf16"] = {"w1": jblocks["mlp"]["w1"], "w2": jblocks["mlp"]["w2"]}
    ttree = tree_map(lambda t: t.to(torch.bfloat16), params_from_numpy(flat))
    tblocks = quant.quantize_model(ttree)["visual"]["blocks"]
    for grp, key in (("attn_q", "wqkv_q"), ("mlp_q", "w1_q"), ("mlp_q", "w2_q")):
        np.testing.assert_array_equal(tblocks[grp][key].numpy(), np.asarray(jblocks[grp][key]))
    jl = [jax.tree.map(lambda a, i=i: a[i], jblocks) for i in range(2)]
    return jl, variants.layer_params(tblocks, HEADS)


def _x(bsz):
    x = np.random.default_rng(bsz).standard_normal((bsz, SEQ, WIDTH)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero LN row: the 1e-6 scale floor
    return torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16)


def _tool_call(wrapper, variant):
    ns = _tool(TOOL[wrapper])
    if wrapper == "int8_attn_nomax":
        def call(x, p):
            wo_q, so = jax_quant.quantize_weight(p["attn"]["wo"])
            return ns["int8_attn_nomax"](
                x, p["ln1"]["scale"], p["ln1"]["bias"], p["attn_q"]["wqkv_q"],
                p["attn_q"]["sqkv"], p["attn"]["bqkv"], wo_q, so, p["attn"]["bo"], None,
                heads=HEADS)
    elif wrapper == "mlp_var":  # as kernel_experiments.py runs it
        def call(x, p):
            q = p["mlp_q"]
            return ns["mlp_var"](x, p["ln2"]["scale"], p["ln2"]["bias"], q["w1_q"], q["s1"],
                                 p["mlp"]["b1"], q["w2_q"], q["s2"], p["mlp"]["b2"],
                                 static_scale=True)
    else:
        fn = ns["mlp_var" if wrapper == "mlp_var3" else "attn_var"]

        def call(x, p):
            return fn(x, p, variant)
    return jax.jit(call, compiler_options=EXACT_BF16)


def _bf16_close(ours, ref):
    o = ours.float().numpy().reshape(-1, ours.shape[-1])
    r = np.asarray(ref.astype(jnp.float32)).reshape(o.shape)
    assert np.isfinite(o).all()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126))) - 7)
    assert (np.abs(o - r) <= ulp).mean() >= 0.99
    zero = ~r.any(-1)  # macbf16 maps the all-zero x row to an all-zero row
    np.testing.assert_array_equal(o[zero], r[zero])
    o, r = o[~zero], r[~zero]
    cos = (o * r).sum(-1) / (np.linalg.norm(o, axis=-1) * np.linalg.norm(r, axis=-1))
    assert cos.min() >= 0.9999, cos.min()


@pytest.mark.parametrize("wrapper,variant", CASES, ids=[f"{w}-{v}" for w, v in CASES])
def test_plain_matches_tool_body(layers, wrapper, variant):
    jl, tl = layers
    run = _tool_call(wrapper, variant)
    wrapped = variants.WRAPPERS[wrapper]
    for bsz in ((1, 2) if wrapper in ("int8_attn_nomax", "mlp_var") else (2,)):
        xt, xj = _x(bsz)
        for i in range(2):
            ref = run(xj, jl[i])
            _build.reset_launch_counts()
            out = wrapped(xt, tl[i], variant)
            assert _build.launch_counts()[wrapper] == 0  # the CPU takes the plain version
            assert out.dtype == torch.bfloat16 and out.shape == xt.shape
            if variant == "maconly":
                np.testing.assert_array_equal(out.float().numpy(),
                                              np.asarray(ref.astype(jnp.float32)))
            else:
                _bf16_close(out, ref)


@pytest.mark.parametrize("variant", variants.WRAPPER_VARIANTS["attn_var5"])
def test_schedules_core_is_row1_plain_core_bit_for_bit(variant):
    """The 16d core is the port's per-head plain core of row 1
    (``fused_attention_qkv_ref``) bit for bit, on scores whose sums pass the
    1e-38 guard."""
    qkv = torch.from_numpy(np.random.default_rng(5).standard_normal((2, SEQ, 3 * WIDTH))
                           .astype(np.float32)).to(torch.bfloat16)
    core = variants._core_ref(qkv, HEADS, variants.ATTN_VARIANTS[variant].core)
    row1 = attention.fused_attention_qkv_ref(qkv, None, HEADS)
    assert torch.equal(core.to(torch.bfloat16), row1.reshape(-1, WIDTH))


def _tool_tuple(path, line):
    """The tuple of strings the tool writes at ``line`` (1-based)."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Tuple) and node.lineno == line and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str) for e in node.elts):
            return tuple(e.value for e in node.elts)
    raise AssertionError(f"no tuple of strings at {path}:{line}")


@pytest.mark.parametrize("exp,line", [(2, 200), (3, 223), (4, 230), (5, 226), (7, 234)])
def test_runner_variant_lists_are_the_tools(exp, line):
    assert kernel_experiments.EXPERIMENTS[exp]["variants"] == _tool_tuple(
        f"tools/kernel_experiments{exp}.py", line)


@pytest.mark.parametrize("wrapper", list(variants.WRAPPER_VARIANTS))
def test_unknown_variant_and_odd_batch_raise(layers, wrapper):
    _, tl = layers
    fn = variants.WRAPPERS[wrapper]
    xt, _ = _x(2)
    with pytest.raises(ValueError, match="unknown variant"):
        fn(xt, tl[0], "prod")
    with pytest.raises(ValueError, match="unknown variant"):
        variants.PLAIN[wrapper](xt, tl[0], "nope")
    x1, _ = _x(1)
    variant = variants.WRAPPER_VARIANTS[wrapper][0]
    if wrapper in ("int8_attn_nomax", "mlp_var"):  # G=1 for an odd batch, as the tool
        assert fn(x1, tl[0], variant).shape == x1.shape
    else:
        with pytest.raises(ValueError, match="odd batch"):
            fn(torch.cat([x1, x1, x1]), tl[0], variant)


def test_runner_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_experiments.run_experiment(2, iters=1, inner=1)


def test_layer_params_carry_the_kmajor_copies(layers):
    """Form 0's int8 products read w^T of each int8 weight: ``layer_params``
    carries them, made once by ``quant.kmajor`` as for the serving tree."""
    _, tl = layers
    for lp in tl:
        for kt, key in (("wqkv_t", "wqkv_q"), ("wo_t", "wo_q"), ("w1_t", "w1_q"),
                        ("w2_t", "w2_q")):
            assert lp[kt] is quant.kmajor(lp[key])
            assert lp[kt].dtype == torch.int8 and lp[kt].is_contiguous()
            assert torch.equal(lp[kt], lp[key].t())


@pytest.mark.parametrize("wrapper", list(variants.WRAPPER_VARIANTS))
def test_kernel_wrappers_refuse_an_unknown_form(layers, wrapper):
    """The card's wrappers take "wgmma" (form 0) or "wmma" (form 1) and raise
    on any other form before the library is built or anything launched."""
    _, tl = layers
    xt, _ = _x(2)
    kernel = variants._mlp_cuda if wrapper.startswith("mlp") else variants._attn_cuda
    _build.reset_launch_counts()
    with pytest.raises(ValueError, match="no 'mma' form"):
        kernel(wrapper, xt, tl[0], variants.WRAPPER_VARIANTS[wrapper][0], form="mma")
    assert _build._LIB is None
    assert not any(_build.launch_counts().values())
