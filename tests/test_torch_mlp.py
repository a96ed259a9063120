"""The port's fused LN+MLP plain version against the JAX package's kernel
(``aiic_tpu.ops.mlp.fused_ln_mlp`` in interpret mode, as tests/test_ops.py
runs it on the CPU).

Tolerances: fp32 ``rtol = atol = 1e-5`` (summation order only); bf16 every
row's cosine >= 0.9999 and >= 99% of elements within 2 bf16 ULPs (a rare
fp32 difference at a rounding boundary of h, the gelu output or the result
moves one bf16 value by an ULP).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiic_tpu.ops import mlp as jax_mlp
from aiic_tpu_torch.ops import mlp, quant

torch.set_num_threads(2)


def _weights(rng, w, m):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"ln_s": 1 + 0.1 * f(w), "ln_b": 0.1 * f(w), "w1": f(w, m) * (2 * w) ** -0.5,
            "b1": 0.1 * f(m), "w2": 0.08 * f(m, w), "b2": 0.1 * f(w)}


NAMES = ("ln_s", "ln_b", "w1", "b1", "w2", "b2")


@pytest.mark.parametrize("shape", [(2, 16, 64), (3, 17, 32)], ids=["even", "odd_rows"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_mlp_plain_matches_jax_kernel(dtype, shape):
    b, s, w = shape
    rng = np.random.default_rng(20)
    p = _weights(rng, w, 4 * w)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bfloat16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    ref = jax_mlp.fused_ln_mlp(xj, *(p[k] for k in NAMES), interpret=True)
    out = mlp.fused_ln_mlp(xt, *(torch.from_numpy(p[k]) for k in NAMES))
    assert out.dtype == xt.dtype and out.shape == xt.shape
    o = out.float().numpy().reshape(-1, w)
    r = np.asarray(ref.astype(jnp.float32)).reshape(o.shape)
    if dtype == "float32":
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5)
        return
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126))) - 7)
    assert (np.abs(o - r) <= 2 * ulp).mean() >= 0.99
    cos = (o * r).sum(-1) / (np.linalg.norm(o, axis=-1) * np.linalg.norm(r, axis=-1))
    assert cos.min() >= 0.9999, cos.min()


def test_gelu_exp2_matches_jax_kernel_form():
    """The plain versions' quick_gelu is the kernels' exp2 form
    ``y / (1 + 2^(fp32(-1.702 log2 e) y))``. The two libraries' exp2 differ
    by a few fp32 ULPs (XLA computes it as exp(y·ln 2)): rtol 2e-6."""
    y = np.linspace(-12, 12, 1001, dtype=np.float32)
    c = jnp.float32(-1.702 * 1.4426950408889634)
    yj = jnp.asarray(y)
    ref = np.asarray(yj * (1.0 / (1.0 + jnp.exp2(c * yj))))
    np.testing.assert_allclose(quant._gelu_exp2(torch.from_numpy(y)).numpy(), ref,
                               rtol=2e-6, atol=1e-30)
