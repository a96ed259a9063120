"""Model configurations — a copy of ``aiic_tpu.models.config``.

The JAX package's ``models/__init__`` pulls in JAX, so the port carries its
own copy of these dataclasses; ``tests/test_torch_bridge.py`` pins every
preset field for field to the original.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    """A transformer tower (shared shape between the image and text encoders)."""

    width: int
    layers: int
    heads: int
    mlp_ratio: int = 4

    @property
    def mlp_dim(self) -> int:
        return self.width * self.mlp_ratio

    @property
    def head_dim(self) -> int:
        assert self.width % self.heads == 0
        return self.width // self.heads


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Full dual-encoder configuration (CLIP ViT geometry)."""

    name: str
    image_size: int = 224
    patch_size: int = 16
    vision: TowerConfig = TowerConfig(width=768, layers=12, heads=12)
    text: TowerConfig = TowerConfig(width=512, layers=12, heads=8)
    vocab_size: int = 49408
    context_length: int = 77
    embed_dim: int = 512
    # "quick_gelu" (x * sigmoid(1.702 x)) is what OpenAI CLIP uses; "gelu" is
    # exact erf gelu.
    gelu_type: str = "quick_gelu"

    @property
    def grid_size(self) -> int:
        assert self.image_size % self.patch_size == 0
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def vision_seq_len(self) -> int:
        return self.num_patches + 1  # + [CLS]


VIT_B_16 = CLIPConfig(name="ViT-B/16")

VIT_B_32 = CLIPConfig(name="ViT-B/32", patch_size=32)

VIT_L_14 = CLIPConfig(
    name="ViT-L/14",
    patch_size=14,
    vision=TowerConfig(width=1024, layers=24, heads=16),
    text=TowerConfig(width=768, layers=12, heads=12),
    embed_dim=768,
)

VIT_L_14_336 = CLIPConfig(
    name="ViT-L/14@336px",
    image_size=336,
    patch_size=14,
    vision=TowerConfig(width=1024, layers=24, heads=16),
    text=TowerConfig(width=768, layers=12, heads=12),
    embed_dim=768,
)

# Small geometry for fast unit tests on the CPU.
TINY_TEST = CLIPConfig(
    name="tiny-test",
    image_size=32,
    patch_size=8,
    vision=TowerConfig(width=64, layers=2, heads=4),
    text=TowerConfig(width=32, layers=2, heads=4),
    vocab_size=512,
    context_length=16,
    embed_dim=32,
)
