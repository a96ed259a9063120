"""The one traffic generator: a traffic mix's file (``traffic/<name>.json``)
names its ``kind`` and parameters, and the kind's runner
(``kinds/<kind>.py``, found by name) makes the inputs from the seed, builds
the program under test, warms it, runs the measured window, and compares
what the window produced with the plain reference.

A kind's module defines ``Runner(ctx)`` with:

- ``setup()``: build and warm the program; nothing is built in the window.
- ``window(seconds, marker)``: the measured window, ending at a boundary of
  its own work (a call, a batch, a step) at or after ``seconds`` and
  counting all the work and all the time up to it. Returns ``window_s``,
  ``attempted``, ``failed``, ``e2e`` (the end-to-end metrics), ``counters``,
  ``images`` and, where the window ends, ``traced_calls``.
- ``finish()``: what is still in flight settled; may return more keys.
- ``compare(control)``: the program's state freed, the numbers worked out
  against the reference (``control == "reference"``: the reference in the
  control's precision in the program's place).

The configuration's ``limits`` are keyed by kind; a mix may name
``limits``, the kind whose limits its comparison is held to (by default its
own). This module holds what the kinds share.
"""

from __future__ import annotations

import gc
import importlib.util
from pathlib import Path
from typing import List, Optional

import numpy as np

from h100_bench import weights as inputs

KINDS = Path(__file__).resolve().parent / "kinds"


def load_kind(name: str):
    """The module ``kinds/<name>.py``."""
    path = KINDS / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no traffic kind {name!r} ({path.name} not in {KINDS})")
    spec = importlib.util.spec_from_file_location(f"h100_bench_kind_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def torch_dtype(name: str):
    import torch

    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def clip_config(cfg: dict):
    from aiic_tpu_torch.models.config import CLIPConfig, TowerConfig

    return CLIPConfig(
        name=cfg["name"], image_size=cfg["image_size"], patch_size=cfg["patch_size"],
        vision=TowerConfig(cfg["vision_width"], cfg["vision_layers"], cfg["vision_heads"],
                           cfg["mlp_ratio"]),
        text=TowerConfig(cfg["text_width"], cfg["text_layers"], cfg["text_heads"],
                         cfg["mlp_ratio"]),
        vocab_size=cfg["vocab_size"], context_length=cfg["context_length"],
        embed_dim=cfg["embed_dim"])


class Context:
    """What a runner is given: the configuration and traffic as loaded, the
    seed, the device, the spans, and the engine or training options (the
    configuration's, or the control's in their place)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans, engine: dict,
                 train: Optional[dict] = None):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.spans, self.engine, self.train = spans, engine, train

    def rng(self, salt: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, salt])


def analyzer(ctx: Context, max_batch: int):
    from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer
    from aiic_tpu_torch.serve.metrics import Metrics

    e = ctx.engine
    weights = inputs.make_weights(ctx.cfg, ctx.seed, ctx.device)
    return InteriorAnalyzer(
        weights, clip_config(ctx.cfg), training_data=ctx.cfg["vocabulary"],
        dtype=torch_dtype(e["dtype"]), quantize=e["quantize"], wire_format=e["wire_format"],
        attn_impl=e["attn_impl"], max_batch=max_batch, metrics=Metrics(), device=ctx.device)


def stage_totals(metrics, name: str):
    s = metrics.stages.summary().get(name)
    return (0, 0.0) if s is None else (s["count"], s["total_s"])


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def release(device) -> None:
    """Freed state returned to the device before the reference runs."""
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def pool_rows(ctx: Context, n: int) -> np.ndarray:
    """A seeded order over the crop pool; every seed runs the same sizes."""
    return ctx.rng(1).permutation(n)


def bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def quantile(values: List[float], q: float) -> float:
    """The q-quantile of the values by linear interpolation (numpy's
    default)."""
    if not values:
        return float("nan")
    return float(np.quantile(np.asarray(values), q))
