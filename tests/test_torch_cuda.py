"""The Hopper kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU with nvcc
and skip elsewhere. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance (as in chip_smoke.py): every row's cosine >= 0.9999 and >= 99% of
elements within 2 bf16 ULPs of the plain version, which differs only in
summation order.
"""

import numpy as np
import pytest
import torch

from aiic_tpu_torch.models.clip import causal_mask
from aiic_tpu_torch.ops import quant

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels have no CPU mode")
    return torch.device("cuda", 0)


def _inputs(device, bsz, seq, width, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, std=1.0, dtype=torch.float32):
        a = (rng.standard_normal(shape) * std).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    x = t(bsz, seq, width, dtype=torch.bfloat16)
    wqkv_q, sqkv = quant.quantize_weight(t(width, 3 * width, std=width ** -0.5))
    w1_q, s1 = quant.quantize_weight(t(width, 4 * width, std=(2 * width) ** -0.5))
    w2_q, s2 = quant.quantize_weight(t(4 * width, width, std=0.01))
    ln = (1 + t(width, std=0.1), t(width, std=0.1))
    attn = (*ln, wqkv_q, sqkv, t(3 * width, std=0.1), t(width, width, std=0.01, dtype=torch.bfloat16),
            t(width, std=0.1))
    mlp = (*ln, w1_q, s1, t(4 * width, std=0.1), w2_q, s2, t(width, std=0.1))
    return x, attn, mlp


def _agree(out, ref):
    o, r = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp(min=2.0 ** -126))) - 7)
    assert ((o - r).abs() <= 2 * ulp).float().mean() >= 0.99
    assert torch.nn.functional.cosine_similarity(o, r, dim=-1).min() >= 0.9999


@pytest.mark.parametrize("shape", [(2, 197, 768, 12, False), (4, 77, 512, 8, True)],
                         ids=["image", "text_causal"])
def test_int8_attention_kernel_matches_plain(device, shape):
    bsz, seq, width, heads, masked = shape
    x, attn, _ = _inputs(device, bsz, seq, width)
    mask = causal_mask(seq, device=device) if masked else None
    before = quant.int8_ln_qkv_attention.launches
    out = quant.int8_ln_qkv_attention(x, *attn, mask, heads=heads)
    torch.cuda.synchronize()
    assert quant.int8_ln_qkv_attention.launches == before + 1
    _agree(out, quant.int8_ln_qkv_attention_ref(x, *attn, mask, heads=heads))


@pytest.mark.parametrize("shape", [(2, 197, 768), (4, 77, 512)], ids=["image", "text"])
def test_int8_mlp_kernel_matches_plain(device, shape):
    x, _, mlp = _inputs(device, *shape)
    before = quant.int8_ln_mlp.launches
    out = quant.int8_ln_mlp(x, *mlp)
    torch.cuda.synchronize()
    assert quant.int8_ln_mlp.launches == before + 1
    _agree(out, quant.int8_ln_mlp_ref(x, *mlp))


def test_kernels_refuse_what_they_do_not_take(device):
    x, attn, mlp = _inputs(device, 1, 17, 768)
    with pytest.raises(TypeError):
        quant.int8_ln_mlp(x.float(), *mlp)
    with pytest.raises(ValueError):
        quant.int8_ln_qkv_attention(x, *attn, heads=16)  # head_dim 48
