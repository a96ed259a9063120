#!/usr/bin/env python3
"""Attribute-F1 of the PyTorch port over an interior_dataset.json (BASELINE.md
tracked metric) — the twin of ``tools/eval_f1.py``.

    python3 tools/torch_eval_f1.py [--dataset-json path] [--image-root dir]
                                   [--use-lora --lora-weights path] [--weights path]
                                   [--limit N] [--device cuda|cpu]

Builds the port's ``InteriorAnalyzer`` as the JAX tool builds its engine
(ViT-B/16, fp32, the HWC wire, ``attn_impl="auto"``: on the card the fp32
packed-QKV core kernel; the vocabulary from the whole dataset; adapters at
rank 4, alpha 8), scores the first ``--limit`` labelled images with
``train.metrics.attribute_f1`` and prints its JSON. ``--device cuda`` (the
default) needs a card and fails without one; ``--device cpu`` runs the
plain versions.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset-json", default="interior_dataset.json")
    ap.add_argument("--image-root", default=None)
    ap.add_argument("--use-lora", action="store_true")
    ap.add_argument("--lora-weights")
    ap.add_argument("--weights")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)

    from aiic_tpu_torch.utils.platform import require_device

    require_device(args.device)

    from aiic_tpu_torch.data.dataset import load_training_data
    from aiic_tpu_torch.engine import InteriorAnalyzer
    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.models.init import load_clip_weights
    from aiic_tpu_torch.train.metrics import attribute_f1

    image_root = args.image_root or os.path.dirname(os.path.abspath(args.dataset_json))
    data = load_training_data(args.dataset_json)
    if args.limit:
        data = data[: args.limit]

    params = (load_clip_weights(args.weights, VIT_B_16, device=args.device)
              if args.weights else None)
    analyzer = InteriorAnalyzer(
        params=params,
        training_data=load_training_data(args.dataset_json),
        use_lora=args.use_lora,
        lora_weights_path=args.lora_weights,
        lora_rank=4,
        lora_alpha=8,
        device=args.device,
    )
    print(json.dumps(attribute_f1(analyzer, data, image_root), indent=2))


if __name__ == "__main__":
    main()
