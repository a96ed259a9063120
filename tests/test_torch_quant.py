"""The port's quantizers and plain kernel versions against the JAX package.

The JAX kernels run as tests/test_ops.py runs them on the CPU: Pallas in
interpret mode. Tolerances: fp32 outputs within 1e-5 (only the summation
order of the LN statistics and the attention sums differs); bf16 outputs
with >= 99% of elements within 1 bf16 ULP and every row's cosine >= 0.9999,
because a rare fp32 difference at a rounding boundary moves a bf16 value or
an int8 quantization step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiic_tpu.models.clip import causal_mask as jax_causal_mask
from aiic_tpu.ops import preprocess as jax_pre
from aiic_tpu.ops import quant as jax_quant
from aiic_tpu_torch.models.clip import causal_mask
from aiic_tpu_torch.ops import preprocess, quant


def _int8_close(ours, ref):
    ours, ref = np.asarray(ours).astype(np.int32), np.asarray(ref).astype(np.int32)
    assert ours.shape == ref.shape
    diff = np.abs(ours - ref)
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


def _bf16_close(ours, ref):
    o = ours.float().numpy().reshape(-1, ours.shape[-1])
    r = np.asarray(ref.astype(jnp.float32)).reshape(o.shape)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126))) - 7)
    assert (np.abs(o - r) <= ulp).mean() >= 0.99
    cos = (o * r).sum(-1) / (np.linalg.norm(o, axis=-1) * np.linalg.norm(r, axis=-1))
    assert cos.min() >= 0.9999, cos.min()


@pytest.mark.parametrize("shape", [(64, 256), (256, 64), (48, 200)])
def test_quantize_weight_matches_jax(shape):
    w = (np.random.default_rng(0).standard_normal(shape) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column
    q, s = quant.quantize_weight(torch.from_numpy(w))
    rq, rs = jax_quant.quantize_weight(jnp.asarray(w))
    _int8_close(q, rq)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-6)
    assert q.dtype == torch.int8 and s.shape == (1, shape[1])


def test_row_quant_matches_jax():
    h = (np.random.default_rng(1).standard_normal((40, 96)) * 3).astype(np.float32)
    h[5] = 0.0  # the 1e-6 floor
    q, s = quant._row_quant(torch.from_numpy(h))
    rq, rs = jax_quant._row_quant(jnp.asarray(h))
    _int8_close(q, rq)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-6)


@pytest.mark.parametrize("patch", [8, 16])
def test_quantize_patch_embed_matches_jax(patch):
    w = (np.random.default_rng(2).standard_normal((3 * patch * patch, 64)) * 0.02).astype(np.float32)
    w[:, 0] = 0.0  # wsc == 0 -> 1
    ours = preprocess.quantize_patch_embed(torch.from_numpy(w))
    ref = jax_pre.quantize_patch_embed(w)
    _int8_close(ours["wq"], ref["wq"])
    for k in ("wsc", "c2"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-6)
    s, ms = preprocess.patch_norm_constants(patch)
    rs, rms = jax_pre.patch_norm_constants(patch)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(ms, rms)


def test_wire_helpers_match_jax():
    px = np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    np.testing.assert_array_equal(preprocess.to_patch_major(px, 8), jax_pre.to_patch_major(px, 8))
    np.testing.assert_allclose(preprocess.normalize_u8(torch.from_numpy(px)).numpy(),
                               np.asarray(jax_pre.normalize_u8(jnp.asarray(px))), rtol=1e-6, atol=1e-6)


def _block_weights(rng, w, m):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "ln_s": 1 + 0.1 * f(w), "ln_b": 0.1 * f(w),
        "wqkv": 0.1 * f(w, 3 * w), "bqkv": 0.1 * f(3 * w),
        "wo": 0.1 * f(w, w), "bo": 0.1 * f(w),
        "w1": 0.08 * f(w, m), "b1": 0.1 * f(m), "w2": 0.08 * f(m, w), "b2": 0.1 * f(w),
    }


def _both(a, dtype):
    """The same numpy array as a torch tensor and a jax array of ``dtype``."""
    t = torch.from_numpy(np.array(a))
    j = jnp.asarray(a)
    if dtype == "bfloat16":
        return t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return t, j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_mlp_plain_matches_jax_kernel(dtype):
    rng = np.random.default_rng(4)
    b, s, w, m = 2, 16, 64, 256
    p = _block_weights(rng, w, m)
    xt, xj = _both(rng.standard_normal((b, s, w)).astype(np.float32), dtype)
    w1_q, s1 = jax_quant.quantize_weight(jnp.asarray(p["w1"]))
    w2_q, s2 = jax_quant.quantize_weight(jnp.asarray(p["w2"]))
    ref = jax_quant.int8_ln_mlp(xj, p["ln_s"], p["ln_b"], w1_q, s1, p["b1"], w2_q, s2,
                                p["b2"], interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = quant.int8_ln_mlp(xt, t(p["ln_s"]), t(p["ln_b"]), t(w1_q), t(s1), t(p["b1"]),
                            t(w2_q), t(s2), t(p["b2"]))
    assert out.dtype == xt.dtype and out.shape == xt.shape
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    else:
        _bf16_close(out, ref)


@pytest.mark.parametrize("use_mask", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_attention_plain_matches_jax_kernel(dtype, use_mask):
    rng = np.random.default_rng(5)
    b, s, w, h = 2, 77, 64, 4
    p = _block_weights(rng, w, 4 * w)
    xt, xj = _both(rng.standard_normal((b, s, w)).astype(np.float32), dtype)
    wq, sq = jax_quant.quantize_weight(jnp.asarray(p["wqkv"]))
    ref = jax_quant.int8_ln_qkv_attention(
        xj, p["ln_s"], p["ln_b"], wq, sq, p["bqkv"], p["wo"], p["bo"],
        jax_causal_mask(s) if use_mask else None, heads=h, interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = quant.int8_ln_qkv_attention(
        xt, t(p["ln_s"]), t(p["ln_b"]), t(wq), t(sq), t(p["bqkv"]), t(p["wo"]), t(p["bo"]),
        causal_mask(s) if use_mask else None, heads=h)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    else:
        _bf16_close(out, ref)


def test_quantize_model_matches_jax_tree():
    import jax

    from aiic_tpu.models.config import TINY_TEST
    from aiic_tpu.models.init import flatten_params, init_clip_params
    from aiic_tpu_torch.models.init import params_from_numpy

    jp = init_clip_params(jax.random.PRNGKey(0), TINY_TEST)
    ref = flatten_params(jax_quant.quantize_model(jp))
    ours = quant.quantize_model(params_from_numpy(flatten_params(jp)))

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
        return out

    ours = flat(ours)
    assert set(ours) == set(ref)
    for k, v in ours.items():
        assert tuple(v.shape) == ref[k].shape, k
        if v.dtype == torch.int8:
            _int8_close(v, ref[k])
        else:
            np.testing.assert_allclose(v.numpy(), ref[k], rtol=1e-6, atol=1e-7, err_msg=k)
