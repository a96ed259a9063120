"""Training CLI of the port — the flags of ``aiic_tpu.cli.train_lora``
(flag-compatible with the reference trainer, train_lora.py:363-387), plus
``--device``:

    python -m aiic_tpu_torch.cli.train_lora --json-path data.json \\
        --save-path out/adapters.pth --epochs 20 --batch-size 8 [--device cuda]

``--weights`` takes backbone weights in any format of
``models.init.load_clip_weights`` (``.npz``, an OpenAI or HF ``.pt``/``.pth``
state dict, an HF checkpoint directory); without it the backbone is a
seeded random init. ``--quantize-text`` (with ``--attn-impl block_fused``)
trains the text tower in the int8 serving numerics on the int8 whole-block
kernels. ``--mesh N --tp T`` trains over an N-rank ``("data", "model")``
mesh, one process per device:

    torchrun --nproc-per-node N -m aiic_tpu_torch.cli.train_lora --mesh N ...

Each rank loads its rows of every batch; rank 0 prints and writes the
adapters and the state. ``--device`` defaults to ``$AIIC_PLATFORM``, else
``cuda``.
"""

from __future__ import annotations

import argparse
import sys

from aiic_tpu_torch.utils.platform import apply_platform_env


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LoRA fine-tuning on an NVIDIA GPU (PyTorch port)")
    p.add_argument("--json-path", type=str, default="interior_dataset.json")
    p.add_argument("--save-path", type=str, default="lora_models/comprehensive_lora_improved.pth")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--rank", type=int, default=16)
    p.add_argument("--alpha", type=int, default=32)
    p.add_argument("--dropout", type=float, default=0.0,
                   help="dropout on the LoRA delta, train-time only (default 0.0)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="compute dtype of the text tower; adapters and optimizer state "
                        "stay fp32")
    p.add_argument("--quantize-image", action="store_true",
                   help="run the frozen image tower with the int8 serving numerics")
    p.add_argument("--quantize-text", action="store_true",
                   help="train the text tower in the int8 serving numerics (needs "
                        "--attn-impl block_fused)")
    p.add_argument("--no-dedup-prompts", action="store_true",
                   help="encode every batch row's tokens instead of the unique-prompt "
                        "pool once per step")
    p.add_argument("--no-feature-cache", action="store_true",
                   help="recompute the frozen image tower every step instead of caching "
                        "per-image features once")
    p.add_argument("--test", action="store_true", help="evaluate a trained adapter")
    p.add_argument("--model", default="vit_b_16",
                   choices=["vit_b_16", "vit_b_32", "vit_l_14", "vit_l_14_336", "tiny"])
    p.add_argument("--weights", type=str, help="backbone weights (.npz / .pt / HF)")
    p.add_argument("--image-root", type=str, help="base dir for dataset image paths")
    p.add_argument("--resume", action="store_true",
                   help="continue from {save-path}.state.npz (full state)")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="train over an N-rank ('data','model') mesh (0 = one device); each "
                        "rank feeds its rows of every batch")
    p.add_argument("--tp", type=int, default=None,
                   help="model-axis size within --mesh (default: auto)")
    p.add_argument("--attn-impl", default="auto",
                   choices=["auto", "xla", "pallas_vjp", "block_fused"],
                   help="text-tower path: 'auto' = pallas_vjp on the card; 'block_fused' = "
                        "the whole-block forward and backward kernels")
    p.add_argument("--device", default=apply_platform_env(),
                   help="torch device (default $AIIC_PLATFORM, else cuda)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from aiic_tpu_torch.cli.common import model_presets
    from aiic_tpu_torch.models.init import load_clip_weights

    mesh, device = None, args.device
    if args.mesh:
        from aiic_tpu_torch.parallel import create_mesh
        from aiic_tpu_torch.parallel.mesh import mesh_device

        # on the card each rank takes its own (LOCAL_RANK's)
        mesh = create_mesh(args.mesh, tp=args.tp,
                           device=None if torch.device(device).type == "cuda" else device)
        device = mesh_device(mesh)
    config = model_presets()[args.model]
    params = load_clip_weights(args.weights, config, device=device) if args.weights else None

    if args.test:
        from aiic_tpu_torch.train import test_trained_lora

        acc = test_trained_lora(args.json_path, args.save_path, params=params, config=config,
                                rank=args.rank, alpha=args.alpha, batch_size=args.batch_size,
                                image_root=args.image_root, device=device)
        print(f"retrieval accuracy: {acc:.4f}")
        return 0

    from aiic_tpu_torch.train import TrainConfig, train_lora

    out = train_lora(
        args.json_path, args.save_path, params=params, config=config,
        cfg=TrainConfig(
            epochs=args.epochs, batch_size=args.batch_size, lr=args.lr, rank=args.rank,
            alpha=args.alpha, lora_dropout=args.dropout, quantize_image=args.quantize_image,
            quantize_text=args.quantize_text, dtype=getattr(torch, args.dtype),
            attn_impl=args.attn_impl, cache_image_features=not args.no_feature_cache,
            dedup_prompts=not args.no_dedup_prompts),
        image_root=args.image_root, mesh=mesh, resume=args.resume, device=device)
    if mesh is None or torch.distributed.get_rank() == 0:
        print(f"best val loss: {out['best_val_loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
