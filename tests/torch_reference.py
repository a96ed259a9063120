"""A synthetic reference tree for the port's tests at TINY_TEST
(``tests/test_torch_examples.py``, ``tests/test_torch_bench_tools.py``):
the reference tree itself is not in the repository.

    make_reference(root) -> root

writes ``interior_dataset.json`` over 20 labelled JPEGs in
``dataset_images/``, ``interior_sample.jpg`` and a seeded rank-4
c_fc/c_proj adapter in ``lora_models/comprehensive_lora.pth``.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch
from PIL import Image

STYLES = ["nowoczesny", "klasyczny", "skandynawski"]
ROOMS = ["kuchnia", "salon", "sypialnia"]
N_IMAGES = 20


def make_reference(root: pathlib.Path) -> pathlib.Path:
    from aiic_tpu_torch.adapters import save_lora_pth
    from aiic_tpu_torch.models.config import TINY_TEST

    (root / "dataset_images").mkdir()
    (root / "lora_models").mkdir()
    rng = np.random.default_rng(31)
    items = []
    for i in range(N_IMAGES):
        name = f"dataset_images/room{i:02d}.jpg"
        a, b = rng.integers(0, 256, 3), rng.integers(0, 256, 3)
        t = np.linspace(0, 1, 48)[None, :, None]
        Image.fromarray((a * (1 - t) + b * t).repeat(40, 0).astype(np.uint8)).save(root / name)
        items.append({"image_path": name, "style": STYLES[i % 3],
                      "characteristics": ["jasne", "przestronne"][: 1 + i % 2],
                      "materials": ["drewno"], "colors": ["biały", "szary"][: 1 + i % 2],
                      "room_type": ROOMS[(i // 3) % 3]})
    (root / "interior_dataset.json").write_text(json.dumps({"training_data": items},
                                                           ensure_ascii=False), encoding="utf-8")
    Image.fromarray(rng.integers(0, 256, (56, 64, 3), dtype=np.uint8)).save(
        root / "interior_sample.jpg")
    t = TINY_TEST.text

    def f(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.02).astype(np.float32))
    save_lora_pth({"c_fc": {"A": f(t.layers, t.width, 4), "B": f(t.layers, 4, t.mlp_dim)},
                   "c_proj": {"A": f(t.layers, t.mlp_dim, 4), "B": f(t.layers, 4, t.width)}},
                  str(root / "lora_models" / "comprehensive_lora.pth"))
    return root
