"""Inputs made from the seed on the device: CLIP weights, crops, token rows
and LoRA adapters.

The benchmark makes every input itself and hands the same tensors to the
program and to the plain reference. Weights come from one ``torch.randn``
on the card, carved into leaves and scaled by OpenAI CLIP's init scheme
(``clip/model.py`` ``initialize_parameters``), in the tree layout the
program takes (linear weights (in, out), ``wqkv`` (W, 3W) [Q | K | V],
blocks stacked on a leading layer axis). Making the same seed twice gives
the same tensors bit for bit, so the reference regenerates its weights
after the program's state is freed instead of sharing them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Tree = Dict[str, object]


def _leaves(cfg: dict) -> List[Tuple[str, Tuple[int, ...], float, str]]:
    """(path, shape, std, kind) of every leaf; kind "normal", "ones" or "zeros"."""
    vw, tw, e = cfg["vision_width"], cfg["text_width"], cfg["embed_dim"]
    p = cfg["patch_size"]
    seq = (cfg["image_size"] // p) ** 2 + 1
    out = [("visual/patch_embed", (3 * p * p, vw), vw ** -0.5, "normal"),
           ("visual/cls", (vw,), vw ** -0.5, "normal"),
           ("visual/pos", (seq, vw), vw ** -0.5, "normal"),
           ("visual/proj", (vw, e), vw ** -0.5, "normal"),
           ("text/tok_embed", (cfg["vocab_size"], tw), 0.02, "normal"),
           ("text/pos", (cfg["context_length"], tw), 0.01, "normal"),
           ("text/proj", (tw, e), tw ** -0.5, "normal")]
    for tower, width, layers in (("visual", vw, cfg["vision_layers"]),
                                 ("text", tw, cfg["text_layers"])):
        mlp = width * cfg["mlp_ratio"]
        proj_std = width ** -0.5 * (2 * layers) ** -0.5
        out += [(f"{tower}/ln_{'pre' if tower == 'visual' else 'final'}/scale", (width,), 0, "ones"),
                (f"{tower}/ln_{'pre' if tower == 'visual' else 'final'}/bias", (width,), 0, "zeros")]
        if tower == "visual":
            out += [("visual/ln_post/scale", (width,), 0, "ones"),
                    ("visual/ln_post/bias", (width,), 0, "zeros")]
        b = f"{tower}/blocks"
        out += [(f"{b}/ln1/scale", (layers, width), 0, "ones"),
                (f"{b}/ln1/bias", (layers, width), 0, "zeros"),
                (f"{b}/ln2/scale", (layers, width), 0, "ones"),
                (f"{b}/ln2/bias", (layers, width), 0, "zeros"),
                (f"{b}/attn/wqkv", (layers, width, 3 * width), width ** -0.5, "normal"),
                (f"{b}/attn/bqkv", (layers, 3 * width), 0.02, "normal"),
                (f"{b}/attn/wo", (layers, width, width), proj_std, "normal"),
                (f"{b}/attn/bo", (layers, width), 0.02, "normal"),
                (f"{b}/mlp/w1", (layers, width, mlp), (2 * width) ** -0.5, "normal"),
                (f"{b}/mlp/b1", (layers, mlp), 0.02, "normal"),
                (f"{b}/mlp/w2", (layers, mlp, width), proj_std, "normal"),
                (f"{b}/mlp/b2", (layers, width), 0.02, "normal")]
    return out


def _put(tree: Tree, path: str, value) -> None:
    node = tree
    parts = path.split("/")
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


def make_weights(cfg: dict, seed: int, device) -> Tree:
    """The CLIP weight tree in float32 on ``device``, from one draw. Biases
    are drawn small and non-zero so that the comparison sees them."""
    leaves = _leaves(cfg)
    total = sum(math.prod(s) for _, s, _, k in leaves if k == "normal")
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    tree: Tree = {}
    at = 0
    for path, shape, std, kind in leaves:
        if kind == "normal":
            n = math.prod(shape)
            leaf = flat[at:at + n].view(shape).mul_(std)
            at += n
        elif kind == "ones":
            leaf = torch.ones(shape, device=device)
        else:
            leaf = torch.zeros(shape, device=device)
        _put(tree, path, leaf)
    _put(tree, "logit_scale", torch.tensor(math.log(1.0 / 0.07), device=device))
    return tree


def make_crops(n: int, size: int, seed: int, device, host: bool = True):
    """(n, size, size, 3) uint8 crops: a smooth field (bilinear from a
    coarse grid) plus noise, made on the card; copied to the host once
    (a numpy array) unless ``host`` is False."""
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    coarse = torch.rand((n, 3, 8, 8), generator=gen, device=device) * 255.0
    field = torch.nn.functional.interpolate(coarse, size=(size, size), mode="bilinear",
                                            align_corners=False)
    noise = torch.randn((n, 3, size, size), generator=gen, device=device) * 24.0
    img = (field + noise).clamp_(0, 255).round_().to(torch.uint8)
    img = img.permute(0, 2, 3, 1).contiguous()
    return img.cpu().numpy() if host else img


def make_token_rows(n: int, cfg: dict, seed: int, device) -> torch.Tensor:
    """(n, context) dense token rows: start of text, random byte-vocabulary
    ids at every position, end of text last, so every position is real."""
    ctx, vocab = cfg["context_length"], cfg["vocab_size"]
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x70CE)
    rows = torch.randint(0, min(512, vocab - 2), (n, ctx), generator=gen, device=device)
    rows[:, 0] = vocab - 2
    rows[:, -1] = vocab - 1
    return rows.to(torch.int32)


def make_lora(cfg: dict, rank: int, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Text-tower adapters {out_proj, c_fc, c_proj: {A (L, in, r), B (L, r, out)}}
    as a partly trained run holds them: A and B both drawn, N(0, 0.02^2)."""
    tw, layers, mlp = cfg["text_width"], cfg["text_layers"], cfg["text_width"] * cfg["mlp_ratio"]
    dims = {"out_proj": (tw, tw), "c_fc": (tw, mlp), "c_proj": (mlp, tw)}
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x10A4)
    tree = {}
    for point, (din, dout) in dims.items():
        tree[point] = {
            "A": torch.randn((layers, din, rank), generator=gen, device=device) * 0.02,
            "B": torch.randn((layers, rank, dout), generator=gen, device=device) * 0.02,
        }
    return tree
