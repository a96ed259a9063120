"""CLIP image normalization constants — copied from
``aiic_tpu.data.preprocess`` (OpenAI CLIP's torchvision ``Normalize``)."""

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)
