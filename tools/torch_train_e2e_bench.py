#!/usr/bin/env python3
"""End-to-end ``train_lora`` wall clock of the PyTorch port on a
production-shaped dataset — the twin of ``tools/train_e2e_bench.py``.

    python3 tools/torch_train_e2e_bench.py [n_items] [batch] [epochs] [text8]
        [--reference DIR] [--model vit_b_16|tiny] [--device cuda|cpu]

The reference dataset is template-generated (a bounded prompt pool over its
items), so a production-scale corpus keeps that pool while the image count
grows. This tool replicates the items of ``<reference>/interior_dataset.json``
to ``n_items`` rows in a temporary dataset JSON (the images on disk stay the
same files) and runs the real ``train_lora`` loop: the feature cache and the
prompt dedup engage as they would for a user. ``text8`` trains on the int8
whole-block text kernels (``attn_impl="block_fused"``, ``quantize_text``).

``--reference`` (default ``$AIIC_REF``, else ``.``) takes the place of the
JAX tool's fixed reference paths. Epoch marks come from the trainer's
``"epoch "`` log lines; the steady state is the mean time between them (the
first epoch pays the decode and the feature precompute). Prints the JAX
tool's one JSON line; the card's name and power limit and the trainer's log
go to stderr. ``--model tiny`` (TINY_TEST) is for the tests; ``--device``
(default ``$AIIC_PLATFORM``, else ``cuda``) exits without a card unless it
is ``cpu``. ``main(argv)`` returns the printed record in a list.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> list:
    from aiic_tpu_torch.utils.platform import apply_platform_env, device_line, require_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_items", nargs="?", type=int, default=2048)
    ap.add_argument("batch", nargs="?", type=int, default=1024)
    ap.add_argument("epochs", nargs="?", type=int, default=1)
    ap.add_argument("flags", nargs="*", help="text8")
    ap.add_argument("--reference", default=os.environ.get("AIIC_REF", "."),
                    help="reference tree with interior_dataset.json and its images "
                         "(default $AIIC_REF, else .)")
    ap.add_argument("--model", default="vit_b_16", choices=["vit_b_16", "tiny"],
                    help="tiny (TINY_TEST) is for the tests")
    ap.add_argument("--device", default=apply_platform_env(),
                    help="torch device (default $AIIC_PLATFORM, else cuda; cpu runs the plain "
                         "versions)")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    import torch

    from aiic_tpu_torch.data.dataset import load_training_data
    from aiic_tpu_torch.models.config import TINY_TEST, VIT_B_16
    from aiic_tpu_torch.train import TrainConfig, train_lora

    n_items, batch, epochs = args.n_items, args.batch, args.epochs
    text8 = "text8" in args.flags
    ref_root = os.path.abspath(args.reference)
    print(f"device={device} ({device_line(device)})", file=sys.stderr, flush=True)

    items = load_training_data(os.path.join(ref_root, "interior_dataset.json"))
    rows = [items[i % len(items)] for i in range(n_items)]
    with tempfile.TemporaryDirectory() as td:
        jp = os.path.join(td, "ds.json")
        with open(jp, "w", encoding="utf-8") as f:
            json.dump({"training_data": rows}, f)

        cfg = TrainConfig(
            epochs=epochs, batch_size=batch, rank=16, alpha=32,
            dtype=torch.bfloat16,
            quantize_text=text8,
            attn_impl="block_fused" if text8 else "auto",
        )
        epoch_marks = []

        def log(m):
            print(m, file=sys.stderr, flush=True)
            if m.startswith("epoch "):
                epoch_marks.append(time.perf_counter())

        t0 = time.perf_counter()
        out = train_lora(
            jp, os.path.join(td, "demo.pth"), cfg=cfg, image_root=ref_root,
            config={"vit_b_16": VIT_B_16, "tiny": TINY_TEST}[args.model],
            log=log, device=device,
        )
        wall = time.perf_counter() - t0

    steps_per_epoch = (len(rows) - max(1, int(len(rows) * cfg.val_fraction))) // batch
    images_per_epoch = steps_per_epoch * batch
    # Steady state = later epochs (the first pays decode + precompute).
    if len(epoch_marks) >= 2:
        steady = (epoch_marks[-1] - epoch_marks[0]) / (len(epoch_marks) - 1)
        value = round(images_per_epoch / steady, 1)
    else:
        steady = wall
        value = round(images_per_epoch / wall, 1)
    rec = {
        "metric": "train_e2e_images_per_sec_steady",
        "value": value,
        "unit": "img/s",
        "epoch_seconds_steady": round(steady, 2),
        "setup_seconds": round(wall - steady * max(1, len(epoch_marks) - 1), 1),
        "n_items": n_items,
        "batch": batch,
        "epochs": epochs,
        "wall_seconds": round(wall, 1),
        "best_val_loss": round(out["best_val_loss"], 4),
    }
    print(json.dumps(rec), flush=True)
    return [rec]


if __name__ == "__main__":
    main()
