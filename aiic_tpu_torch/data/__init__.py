"""Host-side data helpers of the port: copies of the parts of ``aiic_tpu.data``
that the serving engine and the trainer need (tokenizer, dataset loading,
category vocabulary and prompts, training prompts, CLIP preprocessing), each
held to its original by a test, exported under ``aiic_tpu.data``'s names."""

from aiic_tpu_torch.data.dataset import (
    build_category_prompts,
    build_training_prompts,
    extract_all_categories,
    load_training_data,
)
from aiic_tpu_torch.data.preprocess import (
    CLIP_MEAN,
    CLIP_STD,
    preprocess_numpy_batch,
    preprocess_pil,
)
from aiic_tpu_torch.data.tokenizer import ClipTokenizer, tokenize

__all__ = [
    "ClipTokenizer",
    "tokenize",
    "load_training_data",
    "extract_all_categories",
    "build_category_prompts",
    "build_training_prompts",
    "CLIP_MEAN",
    "CLIP_STD",
    "preprocess_pil",
    "preprocess_numpy_batch",
]
