"""int8 serving quantization and the two int8 half-block kernels.

Port of ``aiic_tpu.ops.quant``. Weights quantize per output channel
offline (``quantize_weight``); activations quantize per row inside the
kernels (symmetric, amax/127, ``_row_quant``); integer products accumulate
in int32 and everything after the dequant runs in fp32.

Each half-block has three faces here:

- a **plain version** (``int8_ln_qkv_attention_ref``, ``int8_ln_mlp_ref``):
  the JAX package's reference math in PyTorch ops, on any device. Its
  integer products run as float64 matmuls — exact below 2^53, while fp32 is
  not exact at K=3072 (127·127·3072 > 2^24) and ``torch.matmul`` has no int8
  path on the card.
- a **Hopper kernel** in ``aiic_tpu_torch/csrc`` (CUDA C++ for sm_90a, built
  by ``ops._build``), launched by ``_int8_ln_qkv_attention_cuda`` /
  ``_int8_ln_mlp_cuda``.
- a **public wrapper** with the JAX signature. It takes the plain version
  only for tensors on the CPU; for a CUDA tensor it launches the kernel or
  raises. ``wrapper.launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

import torch

from aiic_tpu_torch.ops.attention import LOG2E, _denom_guard, exp2_rows, no_tf32


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(in, out) fp weight -> (int8 weight, fp32 per-output-channel scale (1, out))."""
    wf = w.float()
    amax = wf.abs().amax(dim=0, keepdim=True)
    # An all-zero column quantizes to zeros, not 0/0.
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def _row_quant(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (rows, d) -> (int8, fp32 per-row scale (rows, 1)); round half to even."""
    amax = h.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(h / scale), -127, 127).to(torch.int8)
    return q, scale


def _gelu_exp2(y: torch.Tensor) -> torch.Tensor:
    """quick_gelu via exp2: sigmoid(1.702 y) = 1 / (1 + 2^(-1.702·log2(e)·y))."""
    c = torch.tensor(-1.702 * LOG2E, dtype=torch.float32, device=y.device)
    return y * (1.0 / (1.0 + torch.exp2(c * y)))


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product through float64."""
    return (a.double() @ b.double()).to(torch.int32)


def _ln_fp32(xf: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics and an fp32 result (the kernels feed
    it to the row quantizer without a cast to the compute dtype)."""
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    h = (xf - mean) * torch.rsqrt(var + eps)
    return h * scale.float() + bias.float()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def int8_ln_mlp_ref(x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2,
                    *, eps: float = 1e-5) -> torch.Tensor:
    """(B, S, W) -> x + int8-MLP(LN(x)); ``_int8_mlp_rows`` with one chunk."""
    no_tf32()
    bsz, seq, width = x.shape
    mlp_dim = w1_q.shape[-1]
    xf = x.float().reshape(bsz * seq, width)
    h = _ln_fp32(xf, ln_scale.reshape(1, width), ln_bias.reshape(1, width), eps)
    hq, hscale = _row_quant(h)
    acc = _int_matmul(hq, w1_q)
    y = acc.float() * hscale * s1.reshape(1, mlp_dim).float() + b1.reshape(1, mlp_dim).float()
    y = _gelu_exp2(y)
    yq, yscale = _row_quant(y)
    acc2 = _int_matmul(yq, w2_q)
    out = acc2.float() * yscale * s2.reshape(1, width).float()
    out = out + b2.reshape(1, width).float()
    return (xf + out).to(x.dtype).reshape(bsz, seq, width)


def int8_ln_qkv_attention_ref(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wo, bo,
                              mask=None, *, heads: int,
                              eps: float = 1e-5) -> torch.Tensor:
    """(B, S, W) -> x + OutProj(Attn(QKV_int8(LN(x)))) with the kernel's
    numerics (``_int8_attn_rows_xla_body``): bf16 qkv after the dequant,
    Q scaled by the bf16-rounded ``scale·log2 e``, clamped no-max exp2
    softmax with the denominator folded past p·V, bf16 output projection."""
    no_tf32()
    bsz, seq, width = x.shape
    dim = width // heads
    scale = dim ** -0.5
    xf = x.float()
    h = _ln_fp32(xf, ln_scale.reshape(1, width), ln_bias.reshape(1, width), eps)
    hq, hscale = _row_quant(h.reshape(bsz * seq, width))
    acc = _int_matmul(hq, wqkv_q)
    qkv = (acc.float() * hscale * sqkv.reshape(1, 3 * width).float()
           + bqkv.reshape(1, 3 * width).float())
    qkv = qkv.to(x.dtype).reshape(bsz, seq, 3, heads, dim)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, S, H, D)

    q = q * torch.tensor(scale * LOG2E, dtype=q.dtype, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if mask is not None:
        s = s + mask.float() * LOG2E
    p = exp2_rows(s)
    denom = _denom_guard(p.sum(dim=-1, keepdim=True))  # (B, H, S, 1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    attn = (o * (1.0 / denom.permute(0, 2, 1, 3))).reshape(bsz * seq, width)

    out = attn.to(x.dtype).float() @ wo.to(x.dtype).float()
    out = out + bo.reshape(1, width).float()
    return (xf + out.reshape(bsz, seq, width)).to(x.dtype)


# ---------------------------------------------------------------------------
# Hopper kernels (aiic_tpu_torch/csrc), launched through ctypes
# ---------------------------------------------------------------------------


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _f32(t: torch.Tensor, n: int, device: torch.device) -> torch.Tensor:
    """A length-n fp32 vector on ``device`` (raises on any other size)."""
    return t.reshape(n).to(device=device, dtype=torch.float32).contiguous()


def _check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _check_inputs(name: str, x: torch.Tensor, *weights) -> None:
    """x must be bf16 (B, S, W); each (weight, shape) contiguous int8 of
    that shape on x's device — the kernel reads them through raw pointers."""
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise TypeError(f"{name}: the Hopper kernel takes bf16 (B, S, W) activations, "
                        f"got {x.dtype} {tuple(x.shape)}")
    for w, shape in weights:
        if (w.dtype != torch.int8 or not w.is_contiguous() or w.device != x.device
                or tuple(w.shape) != shape):
            raise TypeError(f"{name}: int8 weight must be contiguous int8 {shape} on {x.device}, "
                            f"got {w.dtype} {tuple(w.shape)} on {w.device}")


def _int8_ln_mlp_cuda(x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2, eps):
    from aiic_tpu_torch.ops._build import load_library

    bsz, seq, width = x.shape
    mlp_dim = w1_q.shape[-1]
    _check_inputs("int8_ln_mlp", x, (w1_q, (width, mlp_dim)), (w2_q, (mlp_dim, width)))
    if width % 128 or mlp_dim % 128:
        raise ValueError(f"int8_ln_mlp kernel needs W and 4W multiples of 128, got {width}, {mlp_dim}")
    lib = load_library()
    rows = bsz * seq
    x = x.contiguous()
    dev = x.device
    out = torch.empty_like(x)
    hq = torch.empty((rows, width), dtype=torch.int8, device=dev)
    hs = torch.empty((rows,), dtype=torch.float32, device=dev)
    y = torch.empty((rows, mlp_dim), dtype=torch.float32, device=dev)
    yq = torch.empty((rows, mlp_dim), dtype=torch.int8, device=dev)
    ys = torch.empty((rows,), dtype=torch.float32, device=dev)
    args = [x, _f32(ln_scale, width, dev), _f32(ln_bias, width, dev), w1_q,
            _f32(s1, mlp_dim, dev), _f32(b1, mlp_dim, dev), w2_q, _f32(s2, width, dev),
            _f32(b2, width, dev), out, hq, hs, y, yq, ys]
    # The scratch tensors are freed when this returns, before the kernels
    # run: PyTorch's caching allocator reuses their memory only for work
    # queued later on this same (current) stream, so that is safe.
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.aiic_int8_ln_mlp(*[_ptr(a) for a in args], rows, width, mlp_dim,
                              ctypes.c_float(eps), stream)
    _check("int8_ln_mlp", rc)
    return out


def _int8_ln_qkv_attention_cuda(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wo,
                                bo, mask, heads, eps):
    from aiic_tpu_torch.ops._build import load_library

    bsz, seq, width = x.shape
    _check_inputs("int8_ln_qkv_attention", x, (wqkv_q, (width, 3 * width)))
    dim = width // heads
    if dim != 64 or width % 128:
        raise ValueError(f"int8_ln_qkv_attention kernel needs head_dim 64 and W % 128 == 0, "
                         f"got W={width}, H={heads}")
    lib = load_library()
    rows = bsz * seq
    x = x.contiguous()
    dev = x.device
    wo = wo.to(device=dev, dtype=torch.bfloat16).contiguous()
    if wo.shape != (width, width):
        raise ValueError(f"wo must be ({width}, {width}), got {tuple(wo.shape)}")
    if mask is not None:
        mask = mask.to(device=dev, dtype=torch.float32).contiguous()
        if mask.shape != (seq, seq):
            raise ValueError(f"mask must be ({seq}, {seq}), got {tuple(mask.shape)}")
    out = torch.empty_like(x)
    hq = torch.empty((rows, width), dtype=torch.int8, device=dev)
    hs = torch.empty((rows,), dtype=torch.float32, device=dev)
    qkv = torch.empty((rows, 3 * width), dtype=torch.bfloat16, device=dev)
    attn = torch.empty((rows, width), dtype=torch.bfloat16, device=dev)
    # The bf16-rounded scale·log2(e) constant, as jnp.asarray(.., q.dtype).
    qconst = float(torch.tensor(dim ** -0.5 * LOG2E, dtype=torch.bfloat16))
    args = [x, _f32(ln_scale, width, dev), _f32(ln_bias, width, dev), wqkv_q,
            _f32(sqkv, 3 * width, dev), _f32(bqkv, 3 * width, dev), wo, _f32(bo, width, dev),
            mask, out, hq, hs, qkv, attn]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.aiic_int8_ln_qkv_attention(
        *[_ptr(a) for a in args], bsz, seq, width, heads,
        ctypes.c_float(eps), ctypes.c_float(qconst), stream)
    _check("int8_ln_qkv_attention", rc)
    return out


# ---------------------------------------------------------------------------
# Public wrappers (JAX signatures)
# ---------------------------------------------------------------------------


def _route(name: str, x: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version (CPU)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"{name}: no kernel for device {x.device}")


def int8_ln_mlp(x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2,
                *, eps: float = 1e-5) -> torch.Tensor:
    """(B, S, W) -> (B, S, W): x + int8-MLP(LN(x))."""
    if not _route("int8_ln_mlp", x):
        return int8_ln_mlp_ref(x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2, eps=eps)
    out = _int8_ln_mlp_cuda(x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2, eps)
    int8_ln_mlp.launches += 1
    return out


int8_ln_mlp.launches = 0


def int8_ln_qkv_attention(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wo, bo,
                          mask=None, *, heads: int,
                          eps: float = 1e-5) -> torch.Tensor:
    """(B, S, W) -> (B, S, W): x + OutProj_bf16(Attn(QKV_int8(LN(x))))."""
    if not _route("int8_ln_qkv_attention", x):
        return int8_ln_qkv_attention_ref(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv,
                                         wo, bo, mask, heads=heads, eps=eps)
    out = _int8_ln_qkv_attention_cuda(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv,
                                      wo, bo, mask, heads, eps)
    int8_ln_qkv_attention.launches += 1
    return out


int8_ln_qkv_attention.launches = 0


def reset_launch_counts() -> None:
    int8_ln_mlp.launches = 0
    int8_ln_qkv_attention.launches = 0


# ---------------------------------------------------------------------------
# Model quantization
# ---------------------------------------------------------------------------


def _per_layer(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    qs = [quantize_weight(w[i]) for i in range(w.shape[0])]
    return torch.stack([q for q, _ in qs]), torch.stack([s for _, s in qs])


def quantize_attn_blocks(blocks: Dict[str, Any]) -> Dict[str, Any]:
    """Stacked QKV weights -> {wqkv_q, sqkv}; the output projection stays bf16."""
    wqkv_q, sqkv = _per_layer(blocks["attn"]["wqkv"])
    return {"wqkv_q": wqkv_q, "sqkv": sqkv}


def quantize_mlp_blocks(blocks: Dict[str, Any]) -> Dict[str, Any]:
    """Stacked MLP weights -> {w1_q, s1, w2_q, s2}."""
    w1_q, s1 = _per_layer(blocks["mlp"]["w1"])
    w2_q, s2 = _per_layer(blocks["mlp"]["w2"])
    return {"w1_q": w1_q, "s1": s1, "w2_q": w2_q, "s2": s2}


def quantize_model(params: Dict[str, Any]) -> Dict[str, Any]:
    """Full int8 serving quantization: ``attn_q`` and ``mlp_q`` on both
    towers' blocks, plus the int8 folded patch embed for the patch-major
    uint8 wire. The unquantized weights stay: the CLS-row last block and the
    fp paths use them."""
    from aiic_tpu_torch.ops.preprocess import quantize_patch_embed

    out = dict(params)
    for tower in ("visual", "text"):
        t = dict(out[tower])
        blocks = dict(t["blocks"])
        blocks["mlp_q"] = quantize_mlp_blocks(blocks)
        blocks["attn_q"] = quantize_attn_blocks(blocks)
        t["blocks"] = blocks
        out[tower] = t
    out["visual"]["patch_embed_q"] = quantize_patch_embed(out["visual"]["patch_embed"])
    return out
