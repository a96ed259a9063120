"""The port's attention plain versions against the JAX package's kernels.

The JAX kernels run as tests/test_ops.py runs them on the CPU: Pallas in
interpret mode. Tolerances:

- fp32: ``rtol = atol = 1e-5`` (only the summation order of the LN
  statistics and of the score and p·V sums differs);
- bf16: every row's cosine >= 0.9999 and >= 99% of elements within 2 bf16
  ULPs, because a rare fp32 difference at a rounding boundary moves one
  bf16 value (of qkv, p or the output) by an ULP.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiic_tpu.models.clip import causal_mask as jax_causal_mask
from aiic_tpu.ops import attention as jax_attention
from aiic_tpu_torch.models.clip import causal_mask
from aiic_tpu_torch.ops import attention

torch.set_num_threads(2)


def _both(a, dtype):
    """The same numpy array as a torch tensor and a jax array of ``dtype``."""
    t, j = torch.from_numpy(np.array(a)), jnp.asarray(a)
    if dtype == "bfloat16":
        return t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return t, j


def _close(out, ref, dtype):
    o = out.float().numpy().reshape(-1, out.shape[-1])
    r = np.asarray(ref.astype(jnp.float32)).reshape(o.shape)
    if dtype == "float32":
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5)
        return
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126))) - 7)
    assert (np.abs(o - r) <= 2 * ulp).mean() >= 0.99
    cos = (o * r).sum(-1) / (np.linalg.norm(o, axis=-1) * np.linalg.norm(r, axis=-1))
    assert cos.min() >= 0.9999, cos.min()


def _masks(use_mask, seq):
    return (causal_mask(seq), jax_causal_mask(seq)) if use_mask else (None, None)


@pytest.mark.parametrize("use_mask", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attention_qkv_plain_matches_jax_kernel(dtype, use_mask):
    rng = np.random.default_rng(10)
    b, s, w, h = 2, 20, 64, 4
    qt, qj = _both(rng.standard_normal((b, s, 3 * w)).astype(np.float32), dtype)
    mt, mj = _masks(use_mask, s)
    ref = jax_attention.fused_attention_qkv(qj, mj, heads=h, interpret=True)
    out = attention.fused_attention_qkv(qt, mt, heads=h)
    assert out.dtype == qt.dtype and out.shape == (b, s, w)
    _close(out, ref, dtype)


@pytest.mark.parametrize("use_mask", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_qkv_attention_plain_matches_jax_kernel(dtype, use_mask):
    rng = np.random.default_rng(11)
    b, s, w, h = 2, 17, 64, 4
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    p = {"ln_s": 1 + 0.1 * f(w), "ln_b": 0.1 * f(w), "wqkv": f(w, 3 * w) * w ** -0.5,
         "bqkv": 0.1 * f(3 * w), "wo": 0.1 * f(w, w), "bo": 0.1 * f(w)}
    xt, xj = _both(f(b, s, w), dtype)
    mt, mj = _masks(use_mask, s)
    names = ("ln_s", "ln_b", "wqkv", "bqkv", "wo", "bo")
    ref = jax_attention.fused_ln_qkv_attention(xj, *(p[k] for k in names), mj, heads=h,
                                               interpret=True)
    out = attention.fused_ln_qkv_attention(xt, *(torch.from_numpy(p[k]) for k in names), mt,
                                           heads=h)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    _close(out, ref, dtype)


@pytest.mark.parametrize("use_mask", [False, True], ids=["nomask", "causal"])
def test_attention_xla_composition_matches_jax(use_mask):
    rng = np.random.default_rng(12)
    qkv = rng.standard_normal((2, 9, 3 * 32)).astype(np.float32)
    mt, mj = _masks(use_mask, 9)
    ref = jax_attention._attention_qkv_xla(jnp.asarray(qkv), mj, 4)
    out = attention.attention_qkv_ref(torch.from_numpy(qkv), mt, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_no_max_core_is_not_the_stable_softmax():
    """Both cores agree in exact arithmetic where no score passes the clamp;
    past 70 (natural-log units) the no-max core saturates as the JAX kernel
    does, and the stable softmax does not."""
    rng = np.random.default_rng(13)
    qkv = torch.from_numpy(rng.standard_normal((1, 6, 3 * 16)).astype(np.float32))
    torch.testing.assert_close(attention.fused_attention_qkv_ref(qkv, None, 2),
                               attention.attention_qkv_ref(qkv, None, 2), rtol=1e-5, atol=1e-6)
    hot = qkv.clone()
    hot[..., :32] *= 40.0  # q and k scaled: scores far past the clamp
    ref = jax_attention.fused_attention_qkv(jnp.asarray(hot.numpy()), None, heads=2,
                                            interpret=True)
    out = attention.fused_attention_qkv_ref(hot, None, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert not torch.allclose(out, attention.attention_qkv_ref(hot, None, 2), atol=1e-3)
