"""What the port's CLIs share — the port of ``aiic_tpu.cli.common``.

The model presets, and :class:`EngineArgs`: the engine flags every CLI
declares (the JAX package's flags and defaults, plus ``--device``), LoRA
checkpoint loading and rank inference, the text-cache fingerprint and the
construction of the ``InteriorAnalyzer`` they describe.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from aiic_tpu_torch.utils.platform import apply_platform_env, require_device

# Hashed into every ``auto`` text-cache fingerprint: the two packages compute
# text features with different kernels, so neither picks up the other's
# ``.aiic_cache/`` file (an explicit ``--text-cache`` path loads either's).
CACHE_TAG = b"aiic_tpu_torch"


def model_presets() -> Dict[str, Any]:
    from aiic_tpu_torch.models.config import (
        TINY_TEST, VIT_B_16, VIT_B_32, VIT_L_14, VIT_L_14_336,
    )

    return {
        "vit_b_16": VIT_B_16,
        "vit_b_32": VIT_B_32,
        "vit_l_14": VIT_L_14,
        "vit_l_14_336": VIT_L_14_336,
        "tiny": TINY_TEST,
    }


@dataclass
class EngineArgs:
    """The engine knobs every CLI shares. Field defaults are the reference's
    inference defaults; per-CLI overrides go through ``add_args``."""

    model: str = "vit_b_16"
    weights: Optional[str] = None
    dataset_json: str = "interior_dataset.json"
    dtype: str = "float32"
    quantize: bool = False
    use_lora: bool = False
    lora_weights: Optional[str] = None
    lora_rank: Optional[int] = None
    lora_alpha: Optional[float] = None
    wire_format: str = "hwc"
    fast_decode: bool = False
    text_cache: str = "auto"
    mesh_devices: int = 0
    device: str = "cuda"

    @staticmethod
    def add_args(p: argparse.ArgumentParser, *, dtype_default: str = "float32",
                 lora_weights_default: Optional[str] = None) -> None:
        """Declare the shared engine flags on ``p``; only the defaults differ
        per entry point (the batch CLI defaults to fp32, the worker to
        bf16)."""
        p.add_argument("--model", default="vit_b_16", choices=sorted(model_presets()),
                       help="CLIP preset")
        p.add_argument("--weights", type=str,
                       help="backbone weights (.npz / .pt OpenAI / HF dir); default a "
                            "seeded random init")
        p.add_argument("--dataset-json", type=str, default="interior_dataset.json")
        p.add_argument("--dtype", choices=["float32", "bfloat16"], default=dtype_default,
                       help="compute dtype")
        p.add_argument("--quantize", action="store_true",
                       help="int8 serving config: int8 MLP and QKV-projection weights, "
                            "bf16 output projection (requires --dtype bfloat16)")
        p.add_argument("--use-lora", action="store_true")
        p.add_argument("--lora-weights", type=str, default=lora_weights_default)
        p.add_argument("--lora-rank", type=int, default=None,
                       help="adapter rank; default: inferred from the checkpoint, else 4")
        p.add_argument("--lora-alpha", type=float, default=None,
                       help="adapter alpha; default 2*rank")
        p.add_argument("--wire-format", choices=["hwc", "patch"], default="hwc",
                       help="host->device pixel layout: 'patch' = patch-major uint8 from "
                            "the decode pool, normalization folded into the embed")
        p.add_argument("--fast-decode", action="store_true",
                       help="DCT-scaled JPEG decode (quality-approximate, not bit-exact "
                            "PIL preprocessing)")
        p.add_argument("--text-cache", type=str, default="auto",
                       help="precomputed text-feature cache (.npz) path. 'auto' derives a "
                            "config-fingerprinted path under .aiic_cache/; 'none' disables "
                            "caching")
        p.add_argument("--mesh-devices", type=int, default=0,
                       help="shard serving over an N-rank data-parallel mesh (0 = one "
                            "device); run N processes, e.g. torchrun --nproc-per-node N")
        p.add_argument("--device", default=apply_platform_env(),
                       help="torch device (default $AIIC_PLATFORM, else cuda; cpu runs the "
                            "plain versions)")

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "EngineArgs":
        return cls(
            model=args.model,
            weights=args.weights,
            dataset_json=args.dataset_json,
            dtype=args.dtype,
            quantize=args.quantize,
            use_lora=args.use_lora,
            lora_weights=args.lora_weights,
            lora_rank=args.lora_rank,
            lora_alpha=args.lora_alpha,
            wire_format=args.wire_format,
            fast_decode=args.fast_decode,
            text_cache=args.text_cache,
            mesh_devices=args.mesh_devices,
            device=args.device,
        )

    def resolve_lora(self):
        """(ckpt dict or None, rank, alpha): the checkpoint loaded once and
        its geometry inferred from it."""
        ckpt = None
        if self.use_lora and self.lora_weights:
            from aiic_tpu_torch.adapters.torch_convert import load_pth_dict

            ckpt = load_pth_dict(self.lora_weights)
        rank = self.lora_rank
        if rank is None and ckpt is not None:
            from aiic_tpu_torch.adapters.torch_convert import infer_lora_rank

            rank = infer_lora_rank(ckpt)
        rank = rank or 4  # reference inference default (main.py:521-522)
        alpha = self.lora_alpha if self.lora_alpha is not None else 2 * rank
        return ckpt, rank, alpha

    def text_cache_path(self, ckpt, rank, alpha) -> Optional[str]:
        """'auto' -> a path fingerprinting everything that shapes the text
        features (weights content, LoRA checkpoint bytes, merges file,
        dataset, dtype/quantize flags, the package and the device type), so
        a cache from another configuration is never picked up."""
        if self.text_cache in (None, "none"):
            return None
        if self.text_cache != "auto":
            return self.text_cache

        import hashlib
        import os

        import numpy as np
        import torch

        h = hashlib.sha256()
        h.update(repr((self.model, self.weights, self.dtype, self.use_lora,
                       rank, alpha, self.quantize, self.dataset_json)).encode())
        h.update(CACHE_TAG)
        h.update(torch.device(self.device).type.encode())

        def _fp_path(path):
            """File or directory identity (size and mtime per file): a
            retrained checkpoint at the same path invalidates the cache."""
            if not path or not os.path.exists(path):
                h.update(b"missing")
                return
            if os.path.isdir(path):
                for root, _dirs, files in sorted(os.walk(path)):
                    for fn in sorted(files):
                        fp = os.path.join(root, fn)
                        st = os.stat(fp)
                        h.update(f"{os.path.relpath(fp, path)}:{st.st_size}:"
                                 f"{st.st_mtime_ns}".encode())
            else:
                st = os.stat(path)
                h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())

        _fp_path(self.weights)
        # the merges file changes tokenization, so every text feature
        h.update(os.environ.get("AIIC_BPE_PATH", "").encode())
        _fp_path(os.environ.get("AIIC_BPE_PATH"))
        if ckpt is not None:
            for k in sorted(ckpt):
                h.update(k.encode())
                h.update(np.asarray(ckpt[k]).tobytes())
        if os.path.exists(self.dataset_json):
            with open(self.dataset_json, "rb") as f:
                h.update(f.read())
        os.makedirs(".aiic_cache", exist_ok=True)
        return os.path.join(".aiic_cache", f"textcache_{h.hexdigest()[:16]}.npz")

    def build_analyzer(self, *, max_batch: Optional[int] = None,
                       log: Callable[[str], None] = print):
        """Construct the InteriorAnalyzer this config describes. Refuses a
        CUDA device where none is visible (nothing falls back to the CPU).
        ``mesh_devices`` N > 0 serves over ``create_mesh(N, tp=1)``: serving
        is pure data parallelism."""
        import torch

        from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer
        from aiic_tpu_torch.models.init import load_clip_weights

        device = require_device(self.device)
        mesh = None
        if self.mesh_devices:
            from aiic_tpu_torch.parallel import create_mesh
            from aiic_tpu_torch.parallel.mesh import mesh_device

            # on the card each rank takes its own (LOCAL_RANK's)
            mesh = create_mesh(self.mesh_devices, tp=1,
                               device=None if device.type == "cuda" else device)
            device = mesh_device(mesh)
        config = model_presets()[self.model]
        ckpt, rank, alpha = self.resolve_lora()
        text_cache = self.text_cache_path(ckpt, rank, alpha)
        if text_cache:
            log(f"text cache: {text_cache}")
        params = load_clip_weights(self.weights, config, device=device) if self.weights else None
        kw: Dict[str, Any] = {}
        if max_batch is not None:
            kw["max_batch"] = max_batch
        return InteriorAnalyzer(
            params=params,
            config=config,
            dataset_json=self.dataset_json,
            use_lora=self.use_lora,
            lora_weights_path=ckpt if ckpt is not None else self.lora_weights,
            lora_rank=rank,
            lora_alpha=alpha,
            dtype={"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype],
            quantize=self.quantize,
            text_cache=text_cache,
            wire_format=self.wire_format,
            mesh=mesh,
            device=device,
            **kw,
        )
