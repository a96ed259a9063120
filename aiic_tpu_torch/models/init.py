"""Parameter initialization and the weight bridge from the JAX package.

The port keeps the JAX package's public layout: nested dicts of tensors, all
linear weights stored (in, out), ``wqkv`` as (W, 3W) with [Q | K | V]
columns, ``patch_embed`` as (3·p·p, W) flattened channel-major, and each
tower's blocks stacked on a leading layer axis.

- ``params_from_numpy`` takes the flat dict that
  ``aiic_tpu.models.init.flatten_params`` produces (numpy arrays keyed
  ``visual/blocks/attn/wqkv`` …, the layout of ``save_clip_weights`` npz
  files) and returns the port's tree on a device and dtype. A flattened
  LoRA adapter tree (``c_fc/A`` …) comes across the same way.
- ``load_clip_weights`` reads such an npz with numpy alone.
- ``init_clip_params`` reproduces the shapes and distributions of the JAX
  package's OpenAI-CLIP init with a ``torch.Generator``. It does not
  reproduce JAX's random bits: tests that compare the two packages make the
  weights once and hand them to both through ``params_from_numpy``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from aiic_tpu_torch.models.config import CLIPConfig

Params = Dict[str, Any]


def _ln(width: int, device) -> Params:
    return {"scale": torch.ones(width, device=device),
            "bias": torch.zeros(width, device=device)}


def _normal(gen: torch.Generator, shape, std: float, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device) * std


def _init_tower_blocks(gen, layers: int, width: int, mlp_dim: int, device) -> Params:
    """Stacked (leading layer axis) block params, OpenAI CLIP init scheme."""
    attn_std = width ** -0.5
    proj_std = (width ** -0.5) * ((2 * layers) ** -0.5)
    fc_std = (2 * width) ** -0.5
    zeros = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    ones = lambda *s: torch.ones(s, device=device)  # noqa: E731
    return {
        "ln1": {"scale": ones(layers, width), "bias": zeros(layers, width)},
        "ln2": {"scale": ones(layers, width), "bias": zeros(layers, width)},
        "attn": {
            "wqkv": _normal(gen, (layers, width, 3 * width), attn_std, device),
            "bqkv": zeros(layers, 3 * width),
            "wo": _normal(gen, (layers, width, width), proj_std, device),
            "bo": zeros(layers, width),
        },
        "mlp": {
            "w1": _normal(gen, (layers, width, mlp_dim), fc_std, device),
            "b1": zeros(layers, mlp_dim),
            "w2": _normal(gen, (layers, mlp_dim, width), proj_std, device),
            "b2": zeros(layers, width),
        },
    }


def init_clip_params(config: CLIPConfig, generator: torch.Generator,
                     device="cpu") -> Params:
    """Random float32 CLIP params with the JAX package's shapes and
    distributions (``aiic_tpu.models.init.init_clip_params``). ``generator``
    must live on ``device``."""
    vw, tw = config.vision.width, config.text.width
    patch_dim = 3 * config.patch_size * config.patch_size
    vscale = vw ** -0.5
    tscale = tw ** -0.5
    g = generator
    return {
        "visual": {
            "patch_embed": _normal(g, (patch_dim, vw), vscale, device),
            "cls": _normal(g, (vw,), vscale, device),
            "pos": _normal(g, (config.vision_seq_len, vw), vscale, device),
            "ln_pre": _ln(vw, device),
            "blocks": _init_tower_blocks(g, config.vision.layers, vw,
                                         config.vision.mlp_dim, device),
            "ln_post": _ln(vw, device),
            "proj": _normal(g, (vw, config.embed_dim), vscale, device),
        },
        "text": {
            "tok_embed": _normal(g, (config.vocab_size, tw), 0.02, device),
            "pos": _normal(g, (config.context_length, tw), 0.01, device),
            "blocks": _init_tower_blocks(g, config.text.layers, tw,
                                         config.text.mlp_dim, device),
            "ln_final": _ln(tw, device),
            "proj": _normal(g, (tw, config.embed_dim), tscale, device),
        },
        "logit_scale": torch.tensor(math.log(1.0 / 0.07), device=device),
    }


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(flat: Mapping[str, np.ndarray], device="cpu",
                      dtype: Optional[torch.dtype] = torch.float32) -> Params:
    """Flat ``{"a/b/c": ndarray}`` (``aiic_tpu.models.init.flatten_params``)
    -> nested dict of tensors on ``device``. Floating leaves are cast to
    ``dtype`` (``None`` keeps them); integer leaves keep their type."""
    tree: Params = {}
    for key, value in flat.items():
        t = torch.from_numpy(np.array(value))  # a writable copy; keeps 0-d leaves
        if t.is_floating_point() and dtype is not None:
            t = t.to(dtype)
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.to(device)
    return tree


def flatten_params(params: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict of tensors -> flat ``{"a/b/c": ndarray}`` (the npz layout)."""
    flat = {}
    if isinstance(params, Mapping):
        for k, v in params.items():
            flat.update(flatten_params(v, f"{prefix}{k}/"))
    else:
        flat[prefix.rstrip("/")] = params.detach().cpu().numpy()
    return flat


def load_clip_weights(npz_path: str, device="cpu",
                      dtype: Optional[torch.dtype] = torch.float32) -> Params:
    """Read a ``save_clip_weights`` npz (either package) with numpy alone."""
    with np.load(npz_path) as blob:
        flat = {k: blob[k] for k in blob.files}
    return params_from_numpy(flat, device=device, dtype=dtype)


def save_clip_weights(params: Params, path: str) -> None:
    np.savez(path, **flatten_params(params))
