"""Fused LN + MLP + residual — the port of ``aiic_tpu.ops.mlp``.

``fused_ln_mlp`` is ``x + W2·gelu(W1·LN(x))`` in bf16 (TPU kernel
``_mlp_kernel``, selected by ``attn_impl="pallas_mlp"``); kernel
``csrc/ln_mlp.cu``, plain version ``fused_ln_mlp_ref``. The wrapper takes
the plain version only for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from aiic_tpu_torch.ops._build import (
    bf16_activation, check, counted, f32_vector, load_library, ptr, route, weight,
)
from aiic_tpu_torch.ops.attention import _ln_fp32, no_tf32
from aiic_tpu_torch.ops.quant import _gelu_exp2


def fused_ln_mlp_ref(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps: float = 1e-5) -> torch.Tensor:
    """(B, S, W) -> x + MLP(LN(x)) with the TPU kernel's roundings: h = LN(x)
    in fp32 cast to x's dtype; y = h·W1 + b1 with fp32 sums; the exp2
    quick_gelu in fp32, cast to x's dtype; out = dtype(xf + (y·W2 + b2))."""
    no_tf32()
    width = x.shape[-1]
    mlp_dim = w1.shape[-1]
    xf = x.float()
    h = _ln_fp32(xf, ln_scale.reshape(1, width), ln_bias.reshape(1, width), eps).to(x.dtype)
    y = h.float() @ w1.to(x.dtype).float() + b1.reshape(1, mlp_dim).float()
    y = _gelu_exp2(y).to(x.dtype)
    out = y.float() @ w2.to(x.dtype).float() + b2.reshape(1, width).float()
    return (xf + out).to(x.dtype)


def _fused_ln_mlp_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, eps):
    name = "fused_ln_mlp"
    bf16_activation(name, x)
    bsz, seq, width = x.shape
    mlp_dim = w1.shape[-1]
    if width % 128 or mlp_dim % 128:
        raise ValueError(f"{name} kernel needs W and 4W multiples of 128, got {width}, {mlp_dim}")
    lib = load_library()
    rows = bsz * seq
    x = x.contiguous()
    dev = x.device
    w1 = weight(name, w1, (width, mlp_dim), torch.bfloat16, dev)
    w2 = weight(name, w2, (mlp_dim, width), torch.bfloat16, dev)
    out = torch.empty_like(x)
    h = torch.empty((rows, width), dtype=torch.bfloat16, device=dev)
    y = torch.empty((rows, mlp_dim), dtype=torch.bfloat16, device=dev)
    args = [x, f32_vector(ln_scale, width, dev), f32_vector(ln_bias, width, dev), w1,
            f32_vector(b1, mlp_dim, dev), w2, f32_vector(b2, width, dev), out, h, y]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.aiic_ln_mlp(*[ptr(a) for a in args], rows, width, mlp_dim, ctypes.c_float(eps),
                         stream)
    check(name, rc)
    return out


@counted
def fused_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps: float = 1e-5) -> torch.Tensor:
    """(B, S, W) -> (B, S, W): x + MLP(LN(x)), quick_gelu."""
    if not route("fused_ln_mlp", x):
        return fused_ln_mlp_ref(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps)
    out = _fused_ln_mlp_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    fused_ln_mlp.launches += 1
    return out
