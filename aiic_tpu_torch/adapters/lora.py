"""LoRA adapter trees — the port of ``aiic_tpu.adapters.lora``.

An adapter tree is stacked on a leading layer axis, as the backbone blocks
are, with attach points mirroring the reference trainer's wrap set (reference
train_lora.py:76-98): the text tower's ``attn.out_proj``, ``mlp.c_fc`` and
``mlp.c_proj``. ``{point: {"A": (L, in, r), "B": (L, r, out)}}``.

    delta(x) = (x @ A @ B) * (alpha / rank),  A ~ N(0, 0.02^2), B = 0,

so a fresh adapter is a no-op. Training threads the tree through the text
tower (``models.clip.run_tower``); inference folds it into the weights
(``fold_text_lora``: W' = W + scaling * A @ B).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch

from aiic_tpu_torch.models.config import CLIPConfig

Params = Dict[str, Any]

ATTACH_POINTS = ("out_proj", "c_fc", "c_proj")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 4
    alpha: int = 8
    # The shipped reference checkpoints cover only the MLP pair; the reference
    # trainer also wraps out_proj (train_lora.py:81-84).
    attach: Sequence[str] = ("c_fc", "c_proj")

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def _dims(point: str, width: int, mlp_dim: int):
    if point == "out_proj":
        return width, width
    if point == "c_fc":
        return width, mlp_dim
    if point == "c_proj":
        return mlp_dim, width
    raise ValueError(f"unknown LoRA attach point: {point}")


def init_text_lora(generator: torch.Generator, config: CLIPConfig, lora: LoRAConfig,
                   device="cuda") -> Params:
    """Stacked adapter tree over the text tower's layers: A ~ N(0, 0.02^2),
    B = 0 (reference main.py:26-27). A is drawn from ``generator`` (which
    must live on ``device``) point by point in ``lora.attach`` order; it does
    not reproduce JAX's random bits."""
    layers, width, mlp_dim = config.text.layers, config.text.width, config.text.mlp_dim
    tree: Params = {}
    for point in lora.attach:
        din, dout = _dims(point, width, mlp_dim)
        tree[point] = {
            "A": torch.randn((layers, din, lora.rank), generator=generator, device=device) * 0.02,
            "B": torch.zeros((layers, lora.rank, dout), device=device),
        }
    return tree


def fold_tower_lora(blocks: Params, lora_tree: Params, scaling: float) -> Params:
    """W' = W + scaling * A @ B for one tower's stacked blocks (new dicts; the
    input tree is not modified)."""
    wmap = {"c_fc": ("mlp", "w1"), "c_proj": ("mlp", "w2"), "out_proj": ("attn", "wo")}
    new_blocks = dict(blocks)
    for point, ab in lora_tree.items():
        grp, name = wmap[point]
        a = ab["A"].float()
        delta = torch.einsum("lir,lro->lio", a, ab["B"].float().to(a.device)) * scaling
        new_blocks[grp] = dict(new_blocks[grp])
        w = new_blocks[grp][name]
        new_blocks[grp][name] = w + delta.to(device=w.device, dtype=w.dtype)
    return new_blocks


def fold_text_lora(params: Params, lora_tree: Params, scaling: float) -> Params:
    """Backbone params with W' = W + scaling * A @ B baked into the text
    tower: the inference-time form of the reference's runtime ``LoRALinear``
    wrappers (main.py:34-59)."""
    new_text = dict(params["text"])
    new_text["blocks"] = fold_tower_lora(params["text"]["blocks"], lora_tree, scaling)
    out = dict(params)
    out["text"] = new_text
    return out


def lora_param_count(tree: Params) -> int:
    return sum(int(ab[k].numel()) for ab in tree.values() for k in ab)
