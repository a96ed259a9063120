"""CLIP dual encoder as plain functions on tensors — the port of
``aiic_tpu.models.clip``.

Parameters are nested dicts of tensors in the JAX package's layout: linear
weights (in, out), ``wqkv`` (W, 3W) with [Q | K | V] columns, blocks stacked
on a leading layer axis that ``run_tower`` loops over.

Numerics follow the JAX package: LayerNorm statistics in fp32 with the
result cast to the input dtype; every product accumulates in fp32
(``preferred_element_type=float32`` there). Here bf16 operands on the card
go to the bf16 tensor cores with an fp32 result (cuBLAS); everything else is
lifted to fp32, which is exact for bf16 inputs, with TF32 off.

``attn_impl`` takes the JAX package's values and branch order
(``aiic_tpu.models.clip.block``):

- ``"pallas"`` (the default; what ``"auto"`` gives on the card, as JAX's
  does on its accelerator): bf16 blocks run the int8 kernels of ``ops.quant`` when the
  tree carries ``attn_q``/``mlp_q`` (the whole-block kernel ``int8_block``
  where ``_block_plan`` gives a full plan of two images or more, as JAX's
  auto rule takes it, and ``AIIC_FUSED_BLOCK`` = ``0``/``1`` turns it off or
  forces the plan's best blocking; else the two half-block wrappers, which
  follow the JAX planners to the chunked MLP or the large-S attention), else
  the bf16 attention half-block (``ops.attention.fused_ln_qkv_attention``)
  and the plain MLP; fp32 blocks run the plain projections around the
  packed-QKV core kernel (``ops.attention.fused_attention_qkv``);
- ``"pallas_mlp"``: as ``"pallas"``, and an unquantized bf16 MLP runs the
  fused LN+MLP kernel (``ops.mlp.fused_ln_mlp``);
- ``"xla"``: the reference composition (stable softmax, no kernels);
- ``"pallas_vjp"`` (training): the packed-QKV core kernel forward under
  autograd, its backward differentiated through the stable-softmax
  composition (``ops.attention.fused_attention_qkv_vjp``);
- ``"block_fused"`` (training): the whole text block with LoRA on its
  forward and backward kernels (``ops.block_grad.text_block_lora``) where
  the full attach set is present, dropout is 0, the activation is
  quick-gelu and the JAX package's gate admits the geometry; otherwise
  ``"pallas_vjp"``;
- ``"block_fused_int8"`` (training in the int8 serving numerics): the
  whole text block on its int8 forward and backward kernels
  (``ops.block_grad.text_block_lora_int8``) where the tree carries
  ``attn_q``/``mlp_q``, the preconditions of ``"block_fused"`` hold and the
  JAX package's int8 gate admits the geometry; otherwise ``"block_fused"``;
- ``"auto"``: ``"pallas"`` on a CUDA tensor, ``"xla"`` on the CPU, as
  JAX's ``resolve_attn_impl`` resolves it on its accelerator and elsewhere
  (the trainer resolves its own ``"auto"`` to ``"pallas_vjp"`` on the card
  before it calls a block).

LoRA adapters ride along as a stacked tree (``adapters.lora``) on the
``out_proj``, ``c_fc`` and ``c_proj`` linears (``lora_delta``); with
``lora=None`` every path is the serving one.

The last image block runs for the CLS row only, in fp32, on the unquantized
weights (``block_cls``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from aiic_tpu_torch.adapters.lora import ATTACH_POINTS
from aiic_tpu_torch.models.config import CLIPConfig
from aiic_tpu_torch.ops import attention as attention_ops
from aiic_tpu_torch.ops import block_grad
from aiic_tpu_torch.ops import mlp as mlp_ops
from aiic_tpu_torch.ops import quant
from aiic_tpu_torch.ops.attention import _mm, attention_qkv_ref

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------


ATTN_IMPLS = ("auto", "pallas", "pallas_mlp", "pallas_vjp", "block_fused", "block_fused_int8",
              "xla")


def resolve_attn_impl(impl: str, device_type: str) -> str:
    """``"auto"`` -> ``"pallas"`` for a tensor on the card (``device_type``
    ``"cuda"``), ``"xla"`` elsewhere."""
    if impl != "auto":
        return impl
    return "pallas" if device_type == "cuda" else "xla"


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics; the result has x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) — OpenAI CLIP's activation, rounded where JAX
    rounds it in x's dtype: the constant first (a weakly typed Python scalar;
    1.702 is 1.703125 in bf16), then each op of ``jax.nn.sigmoid``'s
    expansion 1 / (1 + exp(-y)). ``torch.sigmoid`` in one op rounds once and
    differs by a bf16 ULP on about a quarter of the elements."""
    y = torch.tensor(1.702, dtype=x.dtype, device=x.device) * x
    return x * (1.0 / (1.0 + torch.exp(-y)))


def _gelu(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "quick_gelu":
        return quick_gelu(x)
    return torch.nn.functional.gelu(x)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """x @ w + b with fp32 sums and one rounding to x's dtype after the bias."""
    y = _mm(x, w.to(x.dtype))
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               scaling: float) -> torch.Tensor:
    """The low-rank delta ``(x @ A @ B) * (alpha/rank)`` in x's dtype, A
    (in, r), B (r, out), each product with fp32 sums and the down-projection
    rounded to x's dtype (reference LoRALayer.forward, main.py:30-31)."""
    down = _mm(x, a.to(x.dtype))
    up = _mm(down.to(x.dtype), b.to(x.dtype))
    return (up * scaling).to(x.dtype)


def _maybe_lora_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                       lora: Optional[Params], scaling: float, dropout: float = 0.0,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``linear`` plus the LoRA delta where an adapter is given; train-time
    inverted dropout on the delta when ``dropout`` > 0 and a generator is
    given (the reference trainer's nn.Dropout on the low-rank path,
    train_lora.py:16-29). The keep mask comes from ``generator``, so it
    matches JAX's only in distribution."""
    y = linear(x, w, b)
    if lora is not None:
        d = lora_delta(x, lora["A"], lora["B"], scaling)
        if dropout > 0.0 and generator is not None:
            keep = torch.rand(d.shape, generator=generator, device=d.device) < 1.0 - dropout
            d = torch.where(keep, d / (1.0 - dropout), torch.zeros_like(d))
        y = y + d
    return y


def attention(x: torch.Tensor, p: Params, heads: int, mask: Optional[torch.Tensor],
              attn_impl: str = "pallas", *, lora_out: Optional[Params] = None,
              lora_scaling: float = 1.0, lora_dropout: float = 0.0,
              lora_generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Multi-head self-attention with the fused [Q|K|V] projection; the core
    is the packed-QKV kernel under ``pallas*``, the same kernel under
    autograd with the stable-softmax backward under ``pallas_vjp``, the
    stable-softmax composition under ``xla``. ``lora_out`` adapts the
    output projection."""
    attn_impl = resolve_attn_impl(attn_impl, x.device.type)
    qkv = linear(x, p["wqkv"], p["bqkv"])
    if attn_impl in ("pallas", "pallas_mlp"):
        out = attention_ops.fused_attention_qkv(qkv, mask, heads=heads)
    elif attn_impl == "pallas_vjp":
        seq = x.shape[1]
        m = (torch.zeros((seq, seq), device=x.device) if mask is None else mask.float())
        out = attention_ops.fused_attention_qkv_vjp(qkv, m, heads)
    else:
        out = attention_qkv_ref(qkv, mask, heads)
    return _maybe_lora_linear(out, p["wo"], p["bo"], lora_out, lora_scaling,
                              lora_dropout, lora_generator)


# ---------------------------------------------------------------------------
# Transformer block + tower
# ---------------------------------------------------------------------------


def block(x: torch.Tensor, p: Params, heads: int, mask: Optional[torch.Tensor],
          gelu_type: str, attn_impl: str = "pallas", *, lora: Optional[Params] = None,
          lora_scaling: float = 1.0, lora_dropout: float = 0.0,
          lora_generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Pre-LN residual block: x + attn(ln1(x)); x + mlp(ln2(x)), each half
    on the first branch that applies, in the JAX package's order. ``lora``
    is one layer's adapter tree ({point: {"A", "B"}}); the dropout mask of
    each attach point comes from ``lora_generator`` in the order out_proj,
    c_fc, c_proj."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    attn_impl = resolve_attn_impl(attn_impl, x.device.type)
    quick = gelu_type == "quick_gelu"
    lora = lora or {}
    l_out, l_fc, l_proj = (lora.get(k) for k in ATTACH_POINTS)
    kernel_lora = all(k in lora for k in ATTACH_POINTS) and lora_dropout == 0.0 and quick
    if attn_impl == "block_fused_int8":
        if (kernel_lora and "attn_q" in p and "mlp_q" in p
                and block_grad.text_block_int8_supported(x.shape[1], x.shape[2],
                                                         p["mlp"]["w1"].shape[-1], heads)):
            seq = x.shape[1]
            m = torch.zeros((seq, seq), device=x.device) if mask is None else mask.float()
            return block_grad.text_block_lora_int8(
                x, {k: p[k] for k in ("ln1", "attn", "ln2", "mlp")},
                {**p["attn_q"], **p["mlp_q"]}, {k: lora[k] for k in ATTACH_POINTS}, m, heads,
                lora_scaling)
        attn_impl = "block_fused"  # no int8 weights or not kernelizable: the bf16 gate
    if attn_impl == "block_fused":
        if kernel_lora and block_grad.text_block_supported(
                x.shape[1], x.shape[2], p["mlp"]["w1"].shape[-1], heads, x.element_size()):
            seq = x.shape[1]
            m = torch.zeros((seq, seq), device=x.device) if mask is None else mask.float()
            return block_grad.text_block_lora(
                x, {k: p[k] for k in ("ln1", "attn", "ln2", "mlp")},
                {k: lora[k] for k in ATTACH_POINTS}, m, heads, lora_scaling)
        attn_impl = "pallas_vjp"  # the configuration is not kernelizable
    kernels = attn_impl in ("pallas", "pallas_mlp") and x.dtype == torch.bfloat16
    a, ln1, ln2, mlp = p["attn"], p["ln1"], p["ln2"], p["mlp"]
    gen = lora_generator if lora_dropout > 0.0 else None
    mlp_lora = l_fc is not None or l_proj is not None
    fused_env = os.environ.get("AIIC_FUSED_BLOCK", "auto")
    if (fused_env != "0" and "attn_q" in p and "mlp_q" in p and kernels and quick
            and l_out is None and not mlp_lora):
        # The whole int8 block where JAX's auto rule takes it: a full plan of
        # two images or more (ViT-B/32 images, every text tower at an even
        # prompt count); AIIC_FUSED_BLOCK=1 takes any plan.
        plan = quant._block_plan(*x.shape, mlp["w1"].shape[-1], x.element_size())
        if fused_env == "1" or (plan is not None and plan[0] == "full" and plan[1] >= 2):
            aq, mq = p["attn_q"], p["mlp_q"]
            out = quant.int8_block(x, ln1["scale"], ln1["bias"], aq["wqkv_q"], aq["sqkv"],
                                   a["bqkv"], a["wo"], a["bo"], mask, ln2["scale"], ln2["bias"],
                                   mq["w1_q"], mq["s1"], mlp["b1"], mq["w2_q"], mq["s2"],
                                   mlp["b2"], heads=heads)
            if out is not None:
                return out
    if "attn_q" in p and kernels and l_out is None:
        q = p["attn_q"]
        x = quant.int8_ln_qkv_attention(x, ln1["scale"], ln1["bias"], q["wqkv_q"], q["sqkv"],
                                        a["bqkv"], a["wo"], a["bo"], mask, heads=heads)
    elif kernels and l_out is None:
        x = attention_ops.fused_ln_qkv_attention(x, ln1["scale"], ln1["bias"], a["wqkv"],
                                                 a["bqkv"], a["wo"], a["bo"], mask, heads=heads)
    else:
        x = x + attention(layer_norm(x, ln1), a, heads, mask, attn_impl, lora_out=l_out,
                          lora_scaling=lora_scaling, lora_dropout=lora_dropout,
                          lora_generator=gen)

    if "mlp_q" in p and kernels and quick and not mlp_lora:
        q = p["mlp_q"]
        return quant.int8_ln_mlp(x, ln2["scale"], ln2["bias"], q["w1_q"], q["s1"], mlp["b1"],
                                 q["w2_q"], q["s2"], mlp["b2"])
    if attn_impl == "pallas_mlp" and kernels and quick and not mlp_lora:
        return mlp_ops.fused_ln_mlp(x, ln2["scale"], ln2["bias"], mlp["w1"], mlp["b1"],
                                    mlp["w2"], mlp["b2"])

    h = layer_norm(x, ln2)
    h = _maybe_lora_linear(h, mlp["w1"], mlp["b1"], l_fc, lora_scaling, lora_dropout, gen)
    h = _gelu(h, gelu_type)
    h = _maybe_lora_linear(h, mlp["w2"], mlp["b2"], l_proj, lora_scaling, lora_dropout, gen)
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
              layers: Optional[range] = None, attn_impl: str = "pallas", *,
              lora: Optional[Params] = None, lora_scaling: float = 1.0, remat: bool = False,
              lora_dropout: float = 0.0,
              lora_generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Run the stacked blocks in order (``layers``: which of them), each with
    its layer of the stacked adapter tree ``lora``.

    ``remat``: each block runs under ``torch.utils.checkpoint`` and is
    recomputed in the backward instead of keeping its activations (the JAX
    package's ``jax.checkpoint`` per scanned block). Dropout draws one seed
    per layer from ``lora_generator`` up front and seeds that layer's masks
    from it, so a recomputed block draws the same masks."""
    use_dropout = lora is not None and lora_dropout > 0.0 and lora_generator is not None
    for i in layers if layers is not None else range(num_layers(blocks)):
        seed = (int(torch.randint(0, 2 ** 62, (), generator=lora_generator,
                                  device=lora_generator.device))
                if use_dropout else None)
        lp = _layer(lora, i) if lora is not None else None

        def run(x, bp=_layer(blocks, i), lp=lp, seed=seed):
            gen = (None if seed is None
                   else torch.Generator(device=x.device).manual_seed(seed))
            return block(x, bp, heads, mask, gelu_type, attn_impl, lora=lp,
                         lora_scaling=lora_scaling,
                         lora_dropout=lora_dropout if use_dropout else 0.0,
                         lora_generator=gen)

        remat_here = remat and torch.is_grad_enabled()
        x = checkpoint(run, x, use_reentrant=False) if remat_here else run(x)
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


_EMBED_SLICE = 1024  # 128·127·1032 < 2^24: an fp32 int8 product of that depth is exact


def _embed_patch_u8(v: Params, pixels: torch.Tensor, config: CLIPConfig,
                    dtype: torch.dtype) -> torch.Tensor:
    """Patch-major uint8 (B, N, 3·p·p) -> (B, N, W) fp32 embed."""
    if "patch_embed_q" in v:
        # int8 embed: (x_u8 ^ 0x80) read as int8 against the int8 folded
        # weight, an int32 product as in the JAX package. It runs in fp32
        # (TF32 off) over depth slices of _EMBED_SLICE rows, each exact (its
        # partial sums are integers of magnitude <= 128·127·1024 < 2^24),
        # summed in int32: exact at every preset (K = 3·p·p is 3072 at
        # ViT-B/32, where one fp32 product is not: 128·127·3072 > 2^24).
        q = v["patch_embed_q"]
        xs8 = (pixels ^ 0x80).view(torch.int8)
        k = xs8.shape[-1]
        acc = sum(_mm(xs8[..., i:i + _EMBED_SLICE], q["wq"][i:i + _EMBED_SLICE]).to(torch.int32)
                  for i in range(0, k, _EMBED_SLICE))
        return acc.float() * q["wsc"].float() + q["c2"].float()
    from aiic_tpu_torch.ops.preprocess import patch_norm_constants

    s, ms = patch_norm_constants(config.patch_size)
    s = torch.as_tensor(s, device=pixels.device)
    ms = torch.as_tensor(ms, device=pixels.device)
    pe = v["patch_embed"].to(dtype)
    w = pe * s[:, None].to(dtype)
    c = _mm(ms.to(dtype), pe)
    return _mm(pixels.to(dtype), w) - c


def encode_image(params: Params, pixels: torch.Tensor, config: CLIPConfig,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "pallas") -> torch.Tensor:
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
                  layers=range(n_layers - 1), attn_impl=attn_impl)
    x = block_cls(x, _layer(v["blocks"], n_layers - 1), config.vision.heads,
                  config.gelu_type)
    x = layer_norm(x, v["ln_post"])
    return _mm(x, v["proj"].to(dtype))


def causal_mask(seq: int, device=None) -> torch.Tensor:
    """Additive causal mask, upper triangle = -inf."""
    return torch.triu(torch.full((seq, seq), float("-inf"), device=device), diagonal=1)


def encode_text(params: Params, tokens: torch.Tensor, config: CLIPConfig,
                dtype: torch.dtype = torch.float32, attn_impl: str = "pallas", *,
                lora: Optional[Params] = None, lora_scaling: float = 1.0, remat: bool = False,
                lora_dropout: float = 0.0,
                lora_generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Text tower: (B, ctx) token ids -> embeddings (B, embed_dim) fp32,
    pooled at the EOT token (the highest id: argmax of the tokens), with the
    stacked adapter tree ``lora`` threaded through the blocks."""
    t = params["text"]
    x = t["tok_embed"][tokens.long()].to(dtype)
    x = x + t["pos"].to(dtype)
    mask = causal_mask(tokens.shape[1], device=x.device)
    x = run_tower(x, t["blocks"], config.text.heads, mask, config.gelu_type,
                  attn_impl=attn_impl, lora=lora, lora_scaling=lora_scaling, remat=remat,
                  lora_dropout=lora_dropout, lora_generator=lora_generator)
    x = layer_norm(x, t["ln_final"])
    eot = torch.argmax(tokens, dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    return _mm(x, t["proj"].to(dtype))


def normalize_features(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """L2-normalize along the last axis in fp32."""
    xf = x.float()
    return xf / (torch.linalg.vector_norm(xf, dim=-1, keepdim=True) + eps)


def clip_forward(params: Params, pixels: torch.Tensor, tokens: torch.Tensor, config: CLIPConfig,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "pallas",
                 text_lora: Optional[Params] = None, lora_scaling: float = 1.0):
    """Joint forward: (logits_per_image, logits_per_text), the reference
    training objective's ``logit_scale.exp() * img @ text.T``
    (train_lora.py:241-243), with the scale in fp32."""
    img = normalize_features(encode_image(params, pixels, config, dtype=dtype, attn_impl=attn_impl))
    txt = normalize_features(encode_text(params, tokens, config, dtype=dtype, attn_impl=attn_impl,
                                         lora=text_lora, lora_scaling=lora_scaling))
    scale = torch.exp(params["logit_scale"]).float()
    logits_per_image = scale * img @ txt.T
    return logits_per_image, logits_per_image.T
