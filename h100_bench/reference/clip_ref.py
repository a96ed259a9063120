"""Plain float32 CLIP ViT, written from OpenAI CLIP's ``clip/model.py``.

The yardstick that decides ``correct``: torch and numpy only, nothing of the
program under test. It takes the benchmark's own weight tree (made from the
seed by ``h100_bench.weights``: linear weights (in, out), ``wqkv`` (W, 3W)
with [Q | K | V] columns, blocks stacked on a leading layer axis) and the
benchmark's raw uint8 crops, token ids and prompts, and works out everything
else itself: the normalisation, the patch embedding, every block in full
(the last one too, then its CLS row), the text features of the prompts, the
detector softmax and the per-category softmax.

Every product runs in float32 with TF32 off. ``prec`` selects the control's
lower precision: ``"fp8"`` (e4m3), ``"int8"`` or ``"int4"`` rounds both
operands of every tower product (patch embedding, QKV, out-projection, both
MLP products), scaled per row of the activations and per output column of
the weights (symmetric for the integers, to the e4m3 range for fp8), and
stores each block's activations in bfloat16, as a program serving in that
precision would.
"""

from __future__ import annotations

import html
import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Products in the reference's precision or the control's
# ---------------------------------------------------------------------------


def _fake_quant(x: torch.Tensor, prec: str, dim: int) -> torch.Tensor:
    """x rounded to ``prec`` with one scale per slice along ``dim``."""
    qmax = 448.0 if prec == "fp8" else 2 ** ({"int8": 8, "int4": 4}[prec] - 1) - 1
    scale = x.abs().amax(dim=dim, keepdim=True) / qmax
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    if prec == "fp8":
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    return torch.clamp(torch.round(x / scale), -qmax, qmax) * scale


def mm(x: torch.Tensor, w: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    """x (..., K) @ w (K, N) in float32; under a control precision both
    operands are rounded first (x per row, w per column)."""
    x, w = x.float(), w.float()
    if prec != "fp32":
        x = _fake_quant(x, prec, -1)
        w = _fake_quant(w, prec, 0)
    return x @ w


def _store(x: torch.Tensor, prec: str) -> torch.Tensor:
    return x if prec == "fp32" else x.to(torch.bfloat16).float()


def layer_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    return torch.nn.functional.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(),
                                          p["bias"].float(), eps)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def lora_linear(x, w, b, lora: Optional[Dict[str, torch.Tensor]], scaling: float, prec: str):
    """x @ w + b, plus the LoRA delta (x @ A @ B) * scaling where given."""
    y = mm(x, w, prec) + b.float()
    if lora is not None:
        y = y + (x.float() @ lora["A"].float() @ lora["B"].float()) * scaling
    return y


def block(x: torch.Tensor, p, heads: int, mask: Optional[torch.Tensor], prec: str = "fp32",
          lora=None, scaling: float = 1.0) -> torch.Tensor:
    """OpenAI CLIP's ResidualAttentionBlock: x + attn(ln_1(x)); x + mlp(ln_2(x)),
    with the LoRA deltas of ``lora`` ({"out_proj"|"c_fc"|"c_proj": {"A", "B"}})."""
    lora = lora or {}
    b, s, w = x.shape
    d = w // heads
    h = _store(layer_norm(x, p["ln1"]), prec)
    qkv = mm(h, p["attn"]["wqkv"], prec) + p["attn"]["bqkv"].float()
    q, k, v = (t.reshape(b, s, heads, d).transpose(1, 2) for t in qkv.split(w, dim=-1))
    scores = (q * d ** -0.5) @ k.transpose(-1, -2)
    if mask is not None:
        scores = scores + mask
    a = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(b, s, w)
    a = _store(a, prec)
    x = _store(x + lora_linear(a, p["attn"]["wo"], p["attn"]["bo"], lora.get("out_proj"),
                               scaling, prec), prec)
    h = _store(layer_norm(x, p["ln2"]), prec)
    h = quick_gelu(lora_linear(h, p["mlp"]["w1"], p["mlp"]["b1"], lora.get("c_fc"), scaling,
                               prec))
    h = _store(h, prec)
    return _store(x + lora_linear(h, p["mlp"]["w2"], p["mlp"]["b2"], lora.get("c_proj"),
                                  scaling, prec), prec)


def _tower(x, blocks, heads, mask, prec, lora=None, scaling=1.0):
    for i in range(blocks["ln1"]["scale"].shape[0]):
        x = block(x, _layer(blocks, i), heads, mask, prec,
                  None if lora is None else _layer(lora, i), scaling)
    return x


# ---------------------------------------------------------------------------
# Towers
# ---------------------------------------------------------------------------


def normalize_pixels(pixels_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) RGB -> float32 normalised with CLIP's mean and std."""
    mean = torch.tensor(CLIP_MEAN, device=pixels_u8.device) * 255.0
    std = torch.tensor(CLIP_STD, device=pixels_u8.device) * 255.0
    return (pixels_u8.float() - mean) / std


def encode_image(weights, pixels: torch.Tensor, config: dict, prec: str = "fp32") -> torch.Tensor:
    """(B, H, W, 3) uint8 crops, or float pixels already normalised -> (B, E)
    image embeddings: conv1 as a product over channel-major patches, the
    class token, positions, ln_pre, every block, ln_post on the CLS row, the
    projection."""
    v = weights["visual"]
    x = normalize_pixels(pixels) if pixels.dtype == torch.uint8 else pixels.float()
    b, hgt, wid, c = x.shape
    p = config["patch_size"]
    patches = x.reshape(b, hgt // p, p, wid // p, p, c).permute(0, 1, 3, 5, 2, 4)
    patches = patches.reshape(b, (hgt // p) * (wid // p), c * p * p)
    x = mm(patches, v["patch_embed"], prec)
    cls = v["cls"].float().expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + v["pos"].float()
    x = _store(layer_norm(x, v["ln_pre"]), prec)
    x = _tower(x, v["blocks"], config["vision_heads"], None, prec)
    return layer_norm(x[:, 0], v["ln_post"]) @ v["proj"].float()


def causal_mask(seq: int, device) -> torch.Tensor:
    return torch.triu(torch.full((seq, seq), float("-inf"), device=device), diagonal=1)


def encode_text(weights, tokens: torch.Tensor, config: dict, prec: str = "fp32", lora=None,
                scaling: float = 1.0) -> torch.Tensor:
    """(B, ctx) token ids -> (B, E) text embeddings, pooled at the end-of-text
    token (the highest id)."""
    t = weights["text"]
    x = t["tok_embed"][tokens.long()].float() + t["pos"].float()
    x = _tower(x, t["blocks"], config["text_heads"], causal_mask(tokens.shape[1], x.device),
               prec, lora, scaling)
    x = layer_norm(x, t["ln_final"])
    x = x[torch.arange(x.shape[0], device=x.device), tokens.long().argmax(dim=-1)]
    return x @ t["proj"].float()


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Prompts, tokens and the heads
# ---------------------------------------------------------------------------

# The published interior detector's 40 prompts; the first 11 are interiors.
DETECTOR_PROMPTS = [
    "interior of a room", "living room", "bedroom", "kitchen", "bathroom",
    "dining room", "office interior", "apartment interior", "house interior",
    "interior design", "home decor",
    "building exterior", "outside of building", "street view", "garden",
    "landscape", "cityscape", "outdoor",
    "floor plan", "blueprint", "architectural plan", "diagram",
    "map", "technical drawing",
    "company logo", "brand logo", "text", "signature",
    "advertisement", "brochure", "flyer",
    "person", "people", "animal", "pet", "car", "vehicle",
    "close-up of object", "product photo", "furniture close-up",
]
INTERIOR_COUNT = 11
CATEGORY_KEYS = ("styles", "characteristics", "materials", "colors", "room_types")


def categories(training_data: Sequence[dict]) -> Dict[str, List[str]]:
    """The attribute vocabulary of a training set, first-seen order, empty
    strings dropped, empty categories left out."""
    fields = {"styles": "style", "characteristics": "characteristics", "materials": "materials",
              "colors": "colors", "room_types": "room_type"}
    out = {}
    for key in CATEGORY_KEYS:
        vals: List[str] = []
        for item in training_data:
            v = item.get(fields[key], [] if key in ("characteristics", "materials", "colors")
                         else "")
            vals.extend(v if isinstance(v, list) else [v])
        vals = [a for a in dict.fromkeys(vals) if a]
        if vals:
            out[key] = vals
    return out


def category_prompts(cats: Dict[str, List[str]]) -> Dict[str, List[str]]:
    """The Polish templates: bare names for room types, "wnętrze z {a}" else."""
    return {k: [a if k == "room_types" else f"wnętrze z {a}" for a in v] for k, v in cats.items()}


def _bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def tokenize(texts: Sequence[str], context: int = 77, vocab: int = 49408) -> np.ndarray:
    """CLIP's tokenizer over its byte vocabulary with no merges: every word is
    its byte tokens, the last one with ``</w>``; start and end of text at the
    top two ids; zero padding to ``context``."""
    import regex as re

    pattern = re.compile(r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
                         r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", re.IGNORECASE)
    enc = _bytes_to_unicode()
    ids_of = {ch: i for i, ch in enumerate(enc.values())}
    out = np.zeros((len(texts), context), np.int32)
    full = 49408  # a smaller test vocabulary folds the byte ids into its range
    for row, text in enumerate(texts):
        text = html.unescape(html.unescape(unicodedata.normalize("NFC", text))).strip()
        text = re.sub(r"\s+", " ", text).strip().lower()
        ids = [vocab - 2]
        for word in re.findall(pattern, text):
            chars = [enc[b] for b in word.encode("utf-8")]
            ids.extend(ids_of[ch] for ch in chars[:-1])
            ids.append(ids_of[chars[-1]] + 256)
        ids = ids[:context - 1] + [vocab - 1]
        if vocab < full:
            ids = [i if i >= vocab - 2 else i % (vocab - 2) for i in ids]
        out[row, :len(ids)] = ids
    return out


class Heads:
    """The text side of the classifier, worked out from the weights: the
    detector prompts' and each category's features."""

    def __init__(self, weights, config: dict, training_data: Sequence[dict], device,
                 prec: str = "fp32"):
        self.cats = categories(training_data)
        prompts = category_prompts(self.cats)
        texts = list(DETECTOR_PROMPTS) + [p for k in self.cats for p in prompts[k]]
        tokens = torch.from_numpy(tokenize(texts, config["context_length"],
                                           config["vocab_size"])).to(device)
        with torch.no_grad():
            feats = normalize(encode_text(weights, tokens, config, prec))
        self.det = feats[:len(DETECTOR_PROMPTS)]
        self.cat_feats = {}
        start = len(DETECTOR_PROMPTS)
        for k in self.cats:
            self.cat_feats[k] = feats[start:start + len(self.cats[k])]
            start += len(self.cats[k])

    def __call__(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, E) normalised image features -> detector probabilities (B, 40)
        and each category's attribute probabilities (B, n_c)."""
        out = {"det": torch.softmax(100.0 * img @ self.det.T, dim=-1)}
        for k, f in self.cat_feats.items():
            out[k] = torch.softmax(100.0 * img @ f.T, dim=-1)
        return out


def classify(weights, pixels_u8: torch.Tensor, config: dict, heads: Heads, prec: str = "fp32",
             block_rows: int = 64) -> Dict[str, torch.Tensor]:
    """Image features and head probabilities of the crops, ``block_rows`` at
    a time, as float32 on the crops' device."""
    feats, probs = [], []
    with torch.no_grad():
        for i in range(0, pixels_u8.shape[0], block_rows):
            f = normalize(encode_image(weights, pixels_u8[i:i + block_rows], config, prec))
            feats.append(f)
            probs.append(heads(f))
    out = {"features": torch.cat(feats)}
    for k in probs[0]:
        out[k] = torch.cat([p[k] for p in probs])
    return out


# ---------------------------------------------------------------------------
# LoRA training: the contrastive loss and optax's clip + AdamW
# ---------------------------------------------------------------------------


def contrastive_loss(img: torch.Tensor, txt: torch.Tensor, logit_scale: torch.Tensor):
    """Symmetric InfoNCE with diagonal labels at ``exp(logit_scale)``."""
    logits = torch.exp(logit_scale.float()) * img.float() @ txt.float().T
    labels = torch.arange(logits.shape[0], device=logits.device)
    ce = torch.nn.functional.cross_entropy
    return (ce(logits, labels) + ce(logits.T, labels)) / 2.0


def adamw_step(params, grads, m, v, step: int, lr: float, weight_decay: float, clip: float,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One step of clip_by_global_norm(clip) then AdamW (decoupled decay) on
    flat dicts of tensors; returns (params, m, v, clipped grads)."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
    factor = 1.0 if norm < clip else clip / norm
    count = step + 1
    new_p, new_m, new_v, clipped = {}, {}, {}, {}
    for k in sorted(grads):
        g = grads[k] * factor
        clipped[k] = g
        new_m[k] = (1 - b1) * g + b1 * m[k]
        new_v[k] = (1 - b2) * g * g + b2 * v[k]
        u = (new_m[k] / (1 - b1 ** count)) / (torch.sqrt(new_v[k] / (1 - b2 ** count)) + eps)
        new_p[k] = params[k] - lr * (u + weight_decay * params[k])
    return new_p, new_m, new_v, clipped


def lora_train(weights, lora: Dict[str, Dict[str, torch.Tensor]], batches, config: dict,
               scaling: float, lr: float, weight_decay: float, clip: float):
    """Follow the LoRA steps: ``batches`` is a list of (image features (B, E)
    normalised, tokens (B, ctx)). Returns per-step losses, the first step's
    clipped gradient per leaf ("point/A"), and the adapters after the last
    step, all float32."""
    params = {f"{p}/{ab}": t.detach().float().clone() for p, d in lora.items()
              for ab, t in d.items()}
    m = {k: torch.zeros_like(t) for k, t in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    losses, first_grads = [], None
    for step, (img, tokens) in enumerate(batches):
        leaves = {k: t.clone().requires_grad_() for k, t in params.items()}
        tree: Dict[str, Dict[str, torch.Tensor]] = {}
        for k, t in leaves.items():
            p, ab = k.split("/")
            tree.setdefault(p, {})[ab] = t
        txt = normalize(encode_text(weights, tokens, config, "fp32", tree, scaling))
        loss = contrastive_loss(img, txt, weights["logit_scale"])
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        params, m, v, clipped = adamw_step(params, grads, m, v, step, lr, weight_decay, clip)
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = clipped
    return losses, first_grads, params
