"""CLIP model: configs, weights and the towers (PyTorch port of
``aiic_tpu.models``, with its names)."""

from aiic_tpu_torch.models.clip import (
    clip_forward,
    encode_image,
    encode_text,
    normalize_features,
)
from aiic_tpu_torch.models.config import (
    TINY_TEST,
    VIT_B_16,
    VIT_B_32,
    VIT_L_14,
    VIT_L_14_336,
    CLIPConfig,
    TowerConfig,
)
from aiic_tpu_torch.models.init import init_clip_params

__all__ = [
    "CLIPConfig",
    "TowerConfig",
    "VIT_B_16",
    "VIT_B_32",
    "VIT_L_14",
    "VIT_L_14_336",
    "TINY_TEST",
    "encode_image",
    "encode_text",
    "clip_forward",
    "normalize_features",
    "init_clip_params",
]
