"""LoRA fine-tuning of the text tower (the port of ``aiic_tpu.train``)."""

from aiic_tpu_torch.train.evaluate import test_trained_lora
from aiic_tpu_torch.train.trainer import (
    TrainConfig,
    contrastive_loss,
    make_optimizer,
    make_train_step,
    precompute_image_features,
    train_lora,
)

__all__ = [
    "TrainConfig", "contrastive_loss", "make_optimizer", "make_train_step",
    "precompute_image_features", "test_trained_lora", "train_lora",
]
