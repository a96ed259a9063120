"""Training state for resume — the port of ``aiic_tpu.train.checkpoint``
(its flat ``.npz`` form; the orbax variants exist for JAX and are not
ported).

One ``.npz`` holds:

- ``lora/{point}/{A|B}``: the adapter tree, fp32;
- ``opt/{point}/{A|B}/exp_avg``, ``.../exp_avg_sq`` and ``.../step``: the
  optimizer state per leaf (``train.trainer.AdamW``), points and factors in
  sorted order;
- ``meta``: UTF-8 JSON of ``epoch``, ``best_val_loss``, ``seed`` and, where
  given, ``rng_state`` (the data-order ``numpy.random.Generator``'s
  ``bit_generator.state``) and ``step`` (the global step count), so that a
  resumed run replays the uninterrupted one.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, Any]
_MOMENTS = ("exp_avg", "exp_avg_sq")


def _leaves(tree: Params):
    return [(p, ab) for p in sorted(tree) for ab in sorted(tree[p])]


def save_train_state(path: str, lora_tree: Params, opt_state: Params, *, epoch: int,
                     best_val_loss: float, seed: int,
                     rng_state: Optional[Dict[str, Any]] = None,
                     step: Optional[int] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {}
    for p, ab in _leaves(lora_tree):
        flat[f"lora/{p}/{ab}"] = lora_tree[p][ab].detach().float().cpu().numpy()
        for name in _MOMENTS:
            flat[f"opt/{p}/{ab}/{name}"] = opt_state[name][p][ab].detach().float().cpu().numpy()
        flat[f"opt/{p}/{ab}/step"] = np.asarray(opt_state["step"], np.int64)
    meta = {"epoch": epoch, "best_val_loss": best_val_loss, "seed": seed}
    if rng_state is not None:
        meta["rng_state"] = rng_state
    if step is not None:
        meta["step"] = int(step)
    flat["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_train_state(path: str, lora_template: Params, opt_state_template: Params,
                     device="cuda") -> Tuple[Params, Params, Dict[str, Any]]:
    """(lora_tree, opt_state, meta) on ``device``, checked leaf by leaf
    against freshly made templates of the current configuration."""
    with np.load(path, allow_pickle=False) as blob:
        data = {k: blob[k] for k in blob.files}
    meta = json.loads(bytes(data.pop("meta").tobytes()).decode())
    lora, moments, steps = {}, {name: {} for name in _MOMENTS}, set()
    for p, ab in _leaves(lora_template):
        arr = data[f"lora/{p}/{ab}"]
        if arr.shape != tuple(lora_template[p][ab].shape):
            raise ValueError(f"lora/{p}/{ab}: {arr.shape} != {tuple(lora_template[p][ab].shape)}")
        lora.setdefault(p, {})[ab] = torch.from_numpy(arr).to(device)
        for name in _MOMENTS:
            m = data[f"opt/{p}/{ab}/{name}"]
            if m.shape != tuple(opt_state_template[name][p][ab].shape):
                raise ValueError(f"opt/{p}/{ab}/{name}: shape {m.shape}")
            moments[name].setdefault(p, {})[ab] = torch.from_numpy(m).to(device)
        steps.add(int(data[f"opt/{p}/{ab}/step"]))
    if len(steps) != 1:
        raise ValueError(f"{path}: the optimizer's leaves disagree on the step: {sorted(steps)}")
    return lora, {**moments, "step": steps.pop()}, meta
