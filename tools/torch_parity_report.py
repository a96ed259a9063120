#!/usr/bin/env python3
"""Golden-parity report of the PyTorch port over a reference dataset's images
— the twin of ``tools/parity_report.py``.

Runs the port and a ``transformers.CLIPModel`` oracle sharing the same
weights over ``<reference-root>/dataset_images/*.jpg`` with identical PIL
preprocessing, and reports the BASELINE.md agreement metric (target >= 0.999)
on the 100·img@text.T logit matrices over the 40 detector prompts, plus
detector-verdict agreement. The oracle runs on the CPU in fp32; the port on
``--device`` (the card by default) in ``--dtype``, with ``--quantize`` the
int8 serving weights (``ops.quant.quantize_model``) and ``--wire patch`` the
patch-major uint8 wire.

With no weights given the oracle is a seeded random ``CLIPModel`` at the
ViT-B/16 geometry (the converter path is the same for real weights). An HF
checkpoint directory becomes both the oracle and the port's weights; any
other weights file is loaded into the port and the oracle is skipped, as the
JAX tool does:

    python3 tools/torch_parity_report.py [--reference-root dir] [--weights path]
        [--limit N] [--attn-impl xla|pallas|auto] [--dtype float32|bfloat16]
        [--quantize] [--wire hwc|patch] [--device cuda|cpu]

Needs ``transformers``. ``--device cuda`` needs a card and fails without one.
"""

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _hf_vit_b16():
    """A seeded random ``transformers.CLIPModel`` at the ViT-B/16 geometry
    (tests/test_parity_torch.py's oracle)."""
    import torch
    from transformers import CLIPConfig, CLIPModel

    cfg = CLIPConfig(
        text_config={
            "hidden_size": 512,
            "intermediate_size": 2048,
            "num_hidden_layers": 12,
            "num_attention_heads": 8,
            "max_position_embeddings": 77,
            "vocab_size": 49408,
            "hidden_act": "quick_gelu",
            "eos_token_id": 49407,
        },
        vision_config={
            "hidden_size": 768,
            "intermediate_size": 3072,
            "num_hidden_layers": 12,
            "num_attention_heads": 12,
            "image_size": 224,
            "patch_size": 16,
            "hidden_act": "quick_gelu",
        },
        projection_dim=512,
    )
    torch.manual_seed(0)
    return CLIPModel(cfg).eval()


def oracle_features(model, pixels, tokens):
    """L2-normalized (image, text) features of a ``CLIPModel``: each tower's
    pooled output through its projection (what ``get_image_features`` /
    ``get_text_features`` compute)."""
    import torch

    with torch.no_grad():
        chunks = []
        for i in range(0, len(pixels), 16):
            chunk = torch.from_numpy(pixels[i: i + 16]).permute(0, 3, 1, 2)
            pooled = model.vision_model(pixel_values=chunk).pooler_output
            chunks.append(model.visual_projection(pooled))
        img = torch.cat(chunks)
        txt = model.text_projection(
            model.text_model(input_ids=torch.from_numpy(tokens)).pooler_output)
    img = img / img.norm(dim=-1, keepdim=True)
    txt = txt / txt.norm(dim=-1, keepdim=True)
    return img.numpy(), txt.numpy()


def verdict(logits: np.ndarray, interior_count: int) -> np.ndarray:
    """The reference's detector rule (main.py:208-220) on 40-prompt logits."""
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return ((p[:, :interior_count].sum(-1) > p[:, interior_count:].sum(-1))
            & (p.max(-1) > 0.3))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference-root", default=".",
                    help="directory holding dataset_images/")
    ap.add_argument("--weights", help="real CLIP weights (.pt OpenAI / HF dir)")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the port (default cuda; cpu runs the plain versions)")
    ap.add_argument("--attn-impl", default="xla", choices=["xla", "pallas", "auto"])
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="compute dtype of the port (the serving config is bfloat16)")
    ap.add_argument("--quantize", action="store_true",
                    help="int8 MLP + attention projection weights — gates the int8 "
                         "serving config against the fp32 oracle")
    ap.add_argument("--wire", default="hwc", choices=["hwc", "patch"],
                    help="the port's input form: 'hwc' = normalized float "
                         "(reference-exact), 'patch' = patch-major uint8 with "
                         "normalization folded into the embed matmul")
    args = ap.parse_args(argv)

    import torch
    from PIL import Image

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is visible; the port runs on "
                         "the card (pass --device cpu for the plain CPU path)")

    from aiic_tpu_torch.data.preprocess import preprocess_pil, preprocess_pil_u8
    from aiic_tpu_torch.data.tokenizer import tokenize
    from aiic_tpu_torch.engine.detector import DETECTOR_CATEGORIES, INTERIOR_COUNT
    from aiic_tpu_torch.models import VIT_B_16, encode_image, encode_text, normalize_features
    from aiic_tpu_torch.models.init import (
        from_hf_clip_state_dict, load_clip_weights, tree_map,
    )

    if args.weights and os.path.isdir(args.weights):
        # An HF checkpoint directory: the same directory becomes both the
        # oracle and (through the tested converter) the port's weights.
        from transformers import CLIPModel

        model = CLIPModel.from_pretrained(args.weights).eval()
        params = load_clip_weights(args.weights, VIT_B_16, device=args.device)
        print(f"oracle: CLIPModel.from_pretrained({args.weights})", file=sys.stderr)
    elif args.weights:
        # OpenAI .pt / .npz: no oracle constructor for this layout; the
        # converter path itself is held to the JAX loader by the tests.
        load_clip_weights(args.weights, VIT_B_16, device=args.device)
        print("NOTE: torch oracle skipped for non-HF external weights "
              "(use an HF checkpoint dir for the full oracle gate)", file=sys.stderr)
        return
    else:
        model = _hf_vit_b16()
        params = from_hf_clip_state_dict(model.state_dict(), VIT_B_16, device=args.device)

    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.dtype]
    if args.quantize and dtype != torch.bfloat16:
        ap.error("--quantize requires --dtype bfloat16 (the serving config)")
    if dtype == torch.bfloat16:
        params = tree_map(lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t, params)
    if args.quantize:
        from aiic_tpu_torch.ops.quant import quantize_model

        params = quantize_model(params)
        print("serving config: bf16 + int8 MLP/attn-projection weights", file=sys.stderr)

    paths = sorted(glob.glob(f"{args.reference_root}/dataset_images/*.jpg"))
    if args.limit:
        paths = paths[: args.limit]
    print(f"scoring {len(paths)} images...", file=sys.stderr)

    pixels = np.stack([preprocess_pil(Image.open(p)) for p in paths])
    if args.wire == "patch":
        from aiic_tpu_torch.ops.preprocess import to_patch_major

        our_pixels = to_patch_major(
            np.stack([preprocess_pil_u8(Image.open(p)) for p in paths]), VIT_B_16.patch_size)
        print("port side: patch-major uint8 wire (folded normalize)", file=sys.stderr)
    else:
        our_pixels = pixels
    tokens = tokenize(DETECTOR_CATEGORIES).astype(np.int64)

    rimg, rtxt = oracle_features(model, pixels, tokens)
    ref_logits = 100.0 * rimg @ rtxt.T

    with torch.inference_mode():
        feats = torch.cat([
            normalize_features(encode_image(
                params, torch.from_numpy(our_pixels[i: i + 16]).to(args.device), VIT_B_16,
                dtype=dtype, attn_impl=args.attn_impl))
            for i in range(0, len(our_pixels), 16)]).cpu().numpy()
        otxt = normalize_features(encode_text(
            params, torch.from_numpy(tokens).to(args.device), VIT_B_16, dtype=dtype,
            attn_impl=args.attn_impl)).cpu().numpy()
    our_logits = 100.0 * feats @ otxt.T

    a, b = our_logits.ravel(), ref_logits.ravel()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    corr = float(np.corrcoef(a, b)[0, 1])
    maxd = float(np.abs(a - b).max())
    agree = float((verdict(our_logits, INTERIOR_COUNT)
                   == verdict(ref_logits, INTERIOR_COUNT)).mean())
    print(json.dumps({
        "images": len(paths),
        "logit_cosine_agreement": round(cos, 6),
        "logit_pearson": round(corr, 6),
        "max_abs_logit_diff": round(maxd, 5),
        "detector_verdict_agreement": agree,
        "passes_0999_bar": cos >= 0.999,
    }))


if __name__ == "__main__":
    main()
