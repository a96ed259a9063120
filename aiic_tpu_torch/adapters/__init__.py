"""LoRA adapters: trees, folding and the reference ``.pth`` layout (the port
of ``aiic_tpu.adapters``)."""

from aiic_tpu_torch.adapters.lora import (
    ATTACH_POINTS,
    LoRAConfig,
    fold_text_lora,
    fold_tower_lora,
    fold_visual_lora,
    init_text_lora,
    init_tower_lora,
    init_visual_lora,
    lora_param_count,
)
from aiic_tpu_torch.adapters.torch_convert import (
    infer_lora_rank,
    lora_tree_from_pth,
    lora_tree_to_pth_dict,
    parse_lora_key,
    save_lora_pth,
)

# aiic_tpu.adapters' names; ATTACH_POINTS, infer_lora_rank and parse_lora_key
# are the port's own, imported here for its trainer and CLIs.
__all__ = [
    "LoRAConfig",
    "init_text_lora",
    "init_visual_lora",
    "init_tower_lora",
    "fold_text_lora",
    "fold_visual_lora",
    "fold_tower_lora",
    "lora_param_count",
    "lora_tree_from_pth",
    "lora_tree_to_pth_dict",
    "save_lora_pth",
]
