"""What the port's CLIs share: the model presets (the ``model_presets`` part
of ``aiic_tpu.cli.common``)."""

from __future__ import annotations

from typing import Any, Dict


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
