"""LoRA adapters of the text tower: trees, folding and the reference ``.pth``
layout (the port of ``aiic_tpu.adapters``)."""

from aiic_tpu_torch.adapters.lora import (
    ATTACH_POINTS,
    LoRAConfig,
    fold_text_lora,
    fold_tower_lora,
    init_text_lora,
    lora_param_count,
)
from aiic_tpu_torch.adapters.torch_convert import (
    infer_lora_rank,
    lora_tree_from_pth,
    lora_tree_to_pth_dict,
    parse_lora_key,
    save_lora_pth,
)

__all__ = [
    "ATTACH_POINTS", "LoRAConfig", "fold_text_lora", "fold_tower_lora", "init_text_lora",
    "lora_param_count", "infer_lora_rank", "lora_tree_from_pth", "lora_tree_to_pth_dict",
    "parse_lora_key", "save_lora_pth",
]
