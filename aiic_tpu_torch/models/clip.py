"""CLIP dual encoder as plain functions on tensors — the port of
``aiic_tpu.models.clip``.

Parameters are nested dicts of tensors in the JAX package's layout: linear
weights (in, out), ``wqkv`` (W, 3W) with [Q | K | V] columns, blocks stacked
on a leading layer axis that ``run_tower`` loops over.

Numerics follow the JAX package: LayerNorm statistics in fp32 with the
result cast to the input dtype; every product accumulates in fp32
(``preferred_element_type=float32`` there — here both operands are lifted to
fp32, which is exact for bf16 inputs, with TF32 off on the card).

The serving path (bf16 with ``attn_q``/``mlp_q`` in the tree) runs each
block as the two int8 half-block kernels of ``ops.quant``; every other tree
or dtype runs the plain fp composition. The last image block runs for the
CLS row only, in fp32, on the unquantized weights (``block_cls``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from aiic_tpu_torch.models.config import CLIPConfig
from aiic_tpu_torch.ops.attention import attention_qkv_ref, no_tf32

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 accumulation (the operands' values, lifted to fp32)."""
    no_tf32()
    return a.float() @ b.float()


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics; the result has x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) — OpenAI CLIP's activation."""
    return x * torch.sigmoid(1.702 * x)


def _gelu(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "quick_gelu":
        return quick_gelu(x)
    return torch.nn.functional.gelu(x)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    y = _mm(x, w.to(x.dtype))
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def attention(x: torch.Tensor, p: Params, heads: int,
              mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Multi-head self-attention with the fused [Q|K|V] projection."""
    bsz, seq, width = x.shape
    qkv = linear(x, p["wqkv"], p["bqkv"])
    out = attention_qkv_ref(qkv, mask, heads).reshape(bsz, seq, width)
    return linear(out, p["wo"], p["bo"])


# ---------------------------------------------------------------------------
# Transformer block + tower
# ---------------------------------------------------------------------------


def block(x: torch.Tensor, p: Params, heads: int, mask: Optional[torch.Tensor],
          gelu_type: str) -> torch.Tensor:
    """Pre-LN residual block: x + attn(ln1(x)); x + mlp(ln2(x)).

    With quantized weights in the tree (``ops.quant.quantize_model``) and a
    bf16 activation, each half runs as one int8 half-block kernel, as the
    JAX package does on its Pallas path."""
    from aiic_tpu_torch.ops.quant import int8_ln_mlp, int8_ln_qkv_attention

    serving = x.dtype == torch.bfloat16
    if "attn_q" in p and serving:
        q = p["attn_q"]
        x = int8_ln_qkv_attention(
            x, p["ln1"]["scale"], p["ln1"]["bias"], q["wqkv_q"], q["sqkv"],
            p["attn"]["bqkv"], p["attn"]["wo"], p["attn"]["bo"], mask, heads=heads)
    else:
        x = x + attention(layer_norm(x, p["ln1"]), p["attn"], heads, mask)

    if "mlp_q" in p and serving and gelu_type == "quick_gelu":
        q = p["mlp_q"]
        return int8_ln_mlp(
            x, p["ln2"]["scale"], p["ln2"]["bias"], q["w1_q"], q["s1"],
            p["mlp"]["b1"], q["w2_q"], q["s2"], p["mlp"]["b2"])

    h = layer_norm(x, p["ln2"])
    h = linear(h, p["mlp"]["w1"], p["mlp"]["b1"])
    h = _gelu(h, gelu_type)
    h = linear(h, p["mlp"]["w2"], p["mlp"]["b2"])
    return x + h


def block_cls(x: torch.Tensor, p: Params, heads: int, gelu_type: str) -> torch.Tensor:
    """The final block restricted to the CLS output row (exact: the pooled
    output reads one row of the last block). K and V project from every
    row; everything after that projection is fp32 with no rounding back to
    the compute dtype. Uses the unquantized weights. Returns (B, W) fp32."""
    bsz, seq, width = x.shape
    dim = width // heads

    h = layer_norm(x, p["ln1"])
    wqkv = p["attn"]["wqkv"].to(h.dtype)
    bqkv = p["attn"]["bqkv"].float()
    q = _mm(h[:, 0], wqkv[:, :width]) + bqkv[:width]  # (B, W)
    kv = _mm(h, wqkv[:, width:]) + bqkv[width:]  # (B, S, 2W)

    qh = q.reshape(bsz, heads, dim)
    kh = kv[..., :width].reshape(bsz, seq, heads, dim)
    vh = kv[..., width:].reshape(bsz, seq, heads, dim)
    scale = dim ** -0.5
    scores = torch.einsum("bhd,bkhd->bhk", qh * scale, kh)
    probs = torch.softmax(scores, dim=-1)
    attn = torch.einsum("bhk,bkhd->bhd", probs, vh).reshape(bsz, width)

    out = _mm(attn, p["attn"]["wo"])
    cls = x[:, 0].float() + out + p["attn"]["bo"].float()
    m = layer_norm(cls, p["ln2"])
    m = _mm(m, p["mlp"]["w1"]) + p["mlp"]["b1"].float()
    m = _gelu(m, gelu_type)
    m = _mm(m, p["mlp"]["w2"]) + p["mlp"]["b2"].float()
    return cls + m


def _layer(tree: Params, i) -> Params:
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def num_layers(blocks: Params) -> int:
    return blocks["ln1"]["scale"].shape[0]


def run_tower(x: torch.Tensor, blocks: Params, heads: int,
              mask: Optional[torch.Tensor], gelu_type: str,
              layers: Optional[range] = None) -> torch.Tensor:
    """Run the stacked blocks in order (``layers``: which of them)."""
    for i in layers if layers is not None else range(num_layers(blocks)):
        x = block(x, _layer(blocks, i), heads, mask, gelu_type)
    return x


# ---------------------------------------------------------------------------
# Towers
# ---------------------------------------------------------------------------


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, C·p·p), channel-major within a patch."""
    b, h, w, c = pixels.shape
    gh, gw = h // patch, w // patch
    x = pixels.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (B, gh, gw, C, p, p)
    return x.reshape(b, gh * gw, c * patch * patch)


def _embed_patch_u8(v: Params, pixels: torch.Tensor, config: CLIPConfig,
                    dtype: torch.dtype) -> torch.Tensor:
    """Patch-major uint8 (B, N, 3·p·p) -> (B, N, W) fp32 embed."""
    if "patch_embed_q" in v:
        # int8 embed: (x_u8 ^ 0x80) read as int8 against the int8 folded
        # weight. The product runs in fp32 (TF32 off) and is exact: every
        # partial sum is an integer of magnitude <= 128·127·768 ≈ 1.25e7 <
        # 2^24 at B/16.
        q = v["patch_embed_q"]
        xs8 = (pixels ^ 0x80).view(torch.int8)
        y = _mm(xs8, q["wq"])
        return y * q["wsc"].float() + q["c2"].float()
    from aiic_tpu_torch.ops.preprocess import patch_norm_constants

    s, ms = patch_norm_constants(config.patch_size)
    s = torch.as_tensor(s, device=pixels.device)
    ms = torch.as_tensor(ms, device=pixels.device)
    pe = v["patch_embed"].to(dtype)
    w = pe * s[:, None].to(dtype)
    c = _mm(ms.to(dtype), pe)
    return _mm(pixels.to(dtype), w) - c


def encode_image(params: Params, pixels: torch.Tensor, config: CLIPConfig,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Image tower: pixels -> embeddings (B, embed_dim) fp32.

    ``pixels`` is normalized float (B, H, W, 3), or patch-major uint8
    (B, N, 3·p·p) — the serving wire, whose normalization folds into the
    embed weight."""
    v = params["visual"]
    if pixels.dim() == 3:
        if pixels.dtype != torch.uint8:
            raise ValueError(f"rank-3 pixels must be patch-major uint8 (B, N, 3*p*p); got {pixels.dtype}")
        x = _embed_patch_u8(v, pixels, config, dtype)
    else:
        x = _mm(patchify(pixels.to(dtype), config.patch_size), v["patch_embed"].to(dtype))
    x = x.to(dtype)

    cls = v["cls"].to(dtype).expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + v["pos"].to(dtype)
    x = layer_norm(x, v["ln_pre"])

    n_layers = num_layers(v["blocks"])
    x = run_tower(x, v["blocks"], config.vision.heads, None, config.gelu_type,
                  layers=range(n_layers - 1))
    x = block_cls(x, _layer(v["blocks"], n_layers - 1), config.vision.heads,
                  config.gelu_type)
    x = layer_norm(x, v["ln_post"])
    return _mm(x, v["proj"].to(dtype))


def causal_mask(seq: int, device=None) -> torch.Tensor:
    """Additive causal mask, upper triangle = -inf."""
    return torch.triu(torch.full((seq, seq), float("-inf"), device=device), diagonal=1)


def encode_text(params: Params, tokens: torch.Tensor, config: CLIPConfig,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Text tower: (B, ctx) token ids -> embeddings (B, embed_dim) fp32,
    pooled at the EOT token (the highest id: argmax of the tokens)."""
    t = params["text"]
    x = t["tok_embed"][tokens.long()].to(dtype)
    x = x + t["pos"].to(dtype)
    mask = causal_mask(tokens.shape[1], device=x.device)
    x = run_tower(x, t["blocks"], config.text.heads, mask, config.gelu_type)
    x = layer_norm(x, t["ln_final"])
    eot = torch.argmax(tokens, dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    return _mm(x, t["proj"].to(dtype))


def normalize_features(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """L2-normalize along the last axis in fp32."""
    xf = x.float()
    return xf / (torch.linalg.vector_norm(xf, dim=-1, keepdim=True) + eps)
