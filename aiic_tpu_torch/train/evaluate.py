"""Adapter evaluation: in-batch contrastive retrieval accuracy — the port of
``aiic_tpu.train.evaluate``.

Reference ``test_trained_lora`` (train_lora.py:309-360): batches of (image,
random-prompt) pairs, predictions the argmax over the batch similarity
matrix, accuracy against the diagonal.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from aiic_tpu_torch.adapters import LoRAConfig, lora_tree_from_pth
from aiic_tpu_torch.data.dataset import load_training_data
from aiic_tpu_torch.models.clip import encode_image, encode_text, normalize_features
from aiic_tpu_torch.models.config import VIT_B_16, CLIPConfig


def test_trained_lora(json_path: str, lora_weights_path: str, *,
                      params: Optional[Dict[str, Any]] = None, config: CLIPConfig = VIT_B_16,
                      rank: int = 16, alpha: int = 32, batch_size: int = 8,
                      image_root: Optional[str] = None, seed: int = 0,
                      device="cuda") -> float:
    """Retrieval accuracy in [0, 1]. On the card the towers run their kernel
    paths (``pallas``; ``pallas_vjp`` for the adapted text tower); on the CPU
    the reference composition (``xla``), as the JAX package evaluates."""
    from aiic_tpu_torch.models.init import init_clip_params
    from aiic_tpu_torch.train.trainer import PromptedImageDataset

    dev = torch.device(device)
    if params is None:
        params = init_clip_params(config, torch.Generator(device=dev).manual_seed(seed),
                                  device=dev)
    lc = LoRAConfig(rank=rank, alpha=alpha, attach=("c_fc", "c_proj", "out_proj"))
    lora_tree, _ = lora_tree_from_pth(lora_weights_path, config, lc, seed=seed, device=dev)
    if image_root is None:
        image_root = os.path.dirname(os.path.abspath(json_path))
    ds = PromptedImageDataset(load_training_data(json_path), config, image_root=image_root)
    rng = np.random.default_rng(seed)
    image_impl, text_impl = ("pallas", "pallas_vjp") if dev.type == "cuda" else ("xla", "xla")

    correct = total = 0
    idx = np.arange(len(ds))
    with torch.no_grad():
        for i in range(0, len(idx) - 1, batch_size):
            sl = idx[i:i + batch_size]
            if len(sl) < 2:
                continue
            pixels, tokens = ds.batch(sl, rng)
            img = normalize_features(encode_image(params, torch.from_numpy(pixels).to(dev),
                                                  config, attn_impl=image_impl))
            txt = normalize_features(encode_text(
                params, torch.from_numpy(tokens).to(dev), config, attn_impl=text_impl,
                lora=lora_tree, lora_scaling=lc.scaling))
            sims = (torch.exp(params["logit_scale"].float()) * img @ txt.T).cpu().numpy()
            correct += int((sims.argmax(axis=1) == np.arange(len(sl))).sum())
            total += len(sl)
    return correct / max(total, 1)
