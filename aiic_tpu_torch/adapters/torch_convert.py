"""Reference ``.pth`` LoRA checkpoints and the stacked adapter tree — the
port of ``aiic_tpu.adapters.torch_convert``.

Checkpoint keys are ``clip_model.transformer.resblocks.{i}.{site}.lora.
{lora_A|lora_B}`` with site ``attn.out_proj``, ``mlp.c_fc`` or ``mlp.c_proj``,
A (in, r) and B (r, out), float32. Whole-model injection adds un-prefixed and
``visual.``-prefixed names (reference main.py:62-74); the reference loads with
a fuzzy ``endswith`` match (main.py:100-107), which ``parse_lora_key``
resolves explicitly: strip any wrapper prefix, route on tower, index on layer.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from aiic_tpu_torch.adapters.lora import LoRAConfig, init_text_lora
from aiic_tpu_torch.models.config import CLIPConfig

Params = Dict[str, Any]

_KEY_RE = re.compile(
    r"^(?P<prefix>.*?)(?P<tower>visual\.)?transformer\.resblocks\."
    r"(?P<layer>\d+)\.(?P<site>attn\.out_proj|mlp\.c_fc|mlp\.c_proj)"
    r"\.lora\.(?P<ab>lora_A|lora_B)$"
)

_SITE_TO_POINT = {"attn.out_proj": "out_proj", "mlp.c_fc": "c_fc", "mlp.c_proj": "c_proj"}
_POINT_TO_SITE = {v: k for k, v in _SITE_TO_POINT.items()}


def parse_lora_key(key: str) -> Optional[Tuple[str, int, str, str]]:
    """-> (tower, layer, attach_point, 'A'|'B') or None if not a LoRA key."""
    m = _KEY_RE.match(key)
    if not m:
        return None
    tower = "visual" if m.group("tower") else "text"
    return tower, int(m.group("layer")), _SITE_TO_POINT[m.group("site")], m.group("ab")[-1]


def load_pth_dict(path_or_dict) -> Mapping[str, Any]:
    """Load a ``.pth`` state dict (pass-through for already-loaded dicts)."""
    if isinstance(path_or_dict, str):
        return torch.load(path_or_dict, map_location="cpu", weights_only=True)
    return path_or_dict


def infer_lora_rank(path_or_dict) -> Optional[int]:
    """Rank from the first text-tower ``lora_A`` key's trailing dim (in, r),
    or None if the checkpoint has no text LoRA key."""
    for key, value in load_pth_dict(path_or_dict).items():
        parsed = parse_lora_key(key)
        if parsed is None or parsed[0] != "text" or parsed[3] != "A":
            continue
        shape = tuple(value.shape)
        if len(shape) == 2:
            return int(shape[1])
    return None


def lora_tree_from_pth(path_or_dict, config: CLIPConfig, lora: LoRAConfig, seed: int = 0,
                       device="cuda") -> Tuple[Params, Dict[str, Any]]:
    """A reference ``.pth`` LoRA checkpoint -> (stacked text-tower tree on
    ``device``, {"loaded": n, "skipped": [keys]}). Non-strict, as the
    reference loads (main.py:86-113): attach points in ``lora.attach`` that
    the checkpoint lacks keep a fresh init (random A from a CPU generator
    seeded with ``seed``, zero B), a no-op; ``visual.*`` keys are skipped."""
    ckpt = load_pth_dict(path_or_dict)
    tree = init_text_lora(torch.Generator().manual_seed(seed), config, lora, device="cpu")
    staged = {p: {ab: tree[p][ab].numpy().copy() for ab in ("A", "B")} for p in tree}
    loaded, skipped = 0, []
    for key, value in ckpt.items():
        parsed = parse_lora_key(key)
        if parsed is None:
            skipped.append(key)
            continue
        tower, layer, point, ab = parsed
        if tower != "text" or point not in staged:
            skipped.append(key)
            continue
        arr = (value.detach().cpu().float().numpy() if isinstance(value, torch.Tensor)
               else np.asarray(value, dtype=np.float32))
        expect = staged[point][ab][layer].shape
        if arr.shape != expect:
            raise ValueError(f"{key}: shape {arr.shape} != expected {expect} "
                             f"(checkpoint rank vs LoRAConfig.rank mismatch?)")
        staged[point][ab][layer] = arr
        loaded += 1
    out = {p: {ab: torch.from_numpy(staged[p][ab]).to(device) for ab in ("A", "B")}
           for p in staged}
    return out, {"loaded": loaded, "skipped": skipped}


def lora_tree_to_pth_dict(tree: Params, prefix: str = "clip_model.") -> Dict[str, np.ndarray]:
    """A stacked text-LoRA tree -> the reference key layout, float32 numpy
    (the trainer's save format, reference train_lora.py:293-299)."""
    out: Dict[str, np.ndarray] = {}
    for point, ab_tree in tree.items():
        site = _POINT_TO_SITE[point]
        a = torch.as_tensor(ab_tree["A"]).detach().float().cpu().numpy()
        b = torch.as_tensor(ab_tree["B"]).detach().float().cpu().numpy()
        for i in range(a.shape[0]):
            base = f"{prefix}transformer.resblocks.{i}.{site}.lora"
            out[f"{base}.lora_A"] = np.ascontiguousarray(a[i])
            out[f"{base}.lora_B"] = np.ascontiguousarray(b[i])
    return out


def save_lora_pth(tree: Params, path: str, prefix: str = "clip_model.") -> None:
    """Write a torch-loadable ``.pth`` of the adapter (reference-compatible)."""
    sd = {k: torch.from_numpy(v.copy()) for k, v in lora_tree_to_pth_dict(tree, prefix).items()}
    torch.save(sd, path)
