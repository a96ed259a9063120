#!/usr/bin/env python3
"""LoRA training-step throughput of the PyTorch port on one card — the twin
of ``tools/train_bench.py``.

    python3 tools/torch_train_bench.py [batch] [iters] [int8] [block] [text8]
                                       [cached] [dedup[=P]] [model=NAME]
                                       [--device cuda|cpu]

The JAX tool's word flags: ``int8`` quantizes the frozen image tower
(serving-numerics adapters); ``block`` selects the whole-text-block kernels
(``attn_impl="block_fused"``); ``text8`` the int8 whole-block text kernels
(implies ``block``); ``cached`` the feature-cache steady state (the image
features computed once by ``train_step.image_features``, every step
text-only); ``dedup[=P]`` (implies ``cached``) the prompt-dedup steady state,
the text tower over a P-prompt pool (default 64). ``model=`` is
``vit_b_16`` (default), ``vit_b_32``, ``vit_l_14``, or ``tiny`` (TINY_TEST,
for the tests). ``--device`` (default ``$AIIC_PLATFORM``, else ``cuda``)
exits without a card unless it is ``cpu``.

Seeded weights cast to bf16, ``TrainConfig(rank=16, alpha=32,
dtype=bfloat16)``, ``make_optimizer``, ``make_train_step``; a synthetic
batch from ``np.random.default_rng(0)`` in the JAX tool's order. There is no
jit and no donation: each timed step ends on the loss's ``float()``, as the
JAX tool's does. Prints the JAX tool's one JSON line; the card's name and
power limit go to stderr. ``main(argv)`` returns the printed record in a
list.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

MODELS = ("vit_b_16", "vit_b_32", "vit_l_14", "tiny")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> list:
    from aiic_tpu_torch.utils.platform import apply_platform_env, device_line, require_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=64)
    ap.add_argument("iters", nargs="?", type=int, default=10)
    ap.add_argument("flags", nargs="*", help="int8 block text8 cached dedup[=P] model=NAME")
    ap.add_argument("--device", default=apply_platform_env(),
                    help="torch device (default $AIIC_PLATFORM, else cuda; cpu runs the plain "
                         "versions)")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    import torch

    from aiic_tpu_torch.adapters import LoRAConfig, init_text_lora
    from aiic_tpu_torch.models import config as configs
    from aiic_tpu_torch.models.init import init_clip_params, tree_map
    from aiic_tpu_torch.train.trainer import TrainConfig, make_optimizer, make_train_step

    batch, iters, flags = args.batch, args.iters, args.flags
    model = "vit_b_16"
    for a in flags:
        if a.startswith("model="):
            model = a.split("=")[1]
    if model not in MODELS:
        raise SystemExit(f"model={model!r}: one of {MODELS}")
    quantize = "int8" in flags
    # "text8": the int8 whole-block text kernels (serving-numerics text
    # tower, straight-through gradients); implies block_fused
    quantize_text = "text8" in flags
    cached = "cached" in flags
    pool_size = 0
    for a in flags:
        if a == "dedup" or a.startswith("dedup="):
            pool_size = int(a.split("=")[1]) if "=" in a else 64
            cached = True
    impl = "block_fused" if ("block" in flags or quantize_text) else "auto"
    config = getattr(configs, "TINY_TEST" if model == "tiny" else model.upper())
    tcfg = TrainConfig(epochs=1, batch_size=batch, rank=16, alpha=32,
                       dtype=torch.bfloat16, quantize_image=quantize,
                       quantize_text=quantize_text, attn_impl=impl)
    log(f"device={device} ({device_line(device)}) model={config.name} batch={batch} "
        f"attn_impl={impl}")

    params = init_clip_params(config, torch.Generator(device=device).manual_seed(0),
                              device=device)
    params = tree_map(lambda t: t.to(torch.bfloat16), params)
    if quantize or quantize_text:
        from aiic_tpu_torch.ops.quant import quantize_model_mlp

        towers = tuple(t for t, on in (("visual", quantize), ("text", quantize_text)) if on)
        params = quantize_model_mlp(params, attn=True, towers=towers)
    lora = init_text_lora(torch.Generator(device=device).manual_seed(1), config,
                          LoRAConfig(16, 32, tcfg.attach), device=device)
    opt = make_optimizer(tcfg, steps_per_epoch=100)
    opt_state = opt.init(lora)
    rng = np.random.default_rng(0)

    def token_rows(n):
        # the JAX tool's rows (ids below 49400 between the start and end
        # tokens, 77 long) at ViT-B/16; within the vocabulary and context of
        # a smaller test model
        vocab = config.vocab_size
        t = rng.integers(1, min(49400, vocab - 3), (n, config.context_length)).astype(np.int32)
        t[:, 0] = min(49406, vocab - 2)
        t[:, -1] = min(49407, vocab - 1)
        return t

    prompt_pool = token_rows(pool_size) if pool_size else None
    train_step, _ = make_train_step(config, tcfg, opt, cached_image=cached,
                                    prompt_pool=prompt_pool, device=device)
    log(f"text path: {train_step.text_impl}")

    pixels = torch.from_numpy(rng.standard_normal(
        (batch, config.image_size, config.image_size, 3)).astype(np.float32)).to(
            device, torch.bfloat16)
    if cached:
        # the feature-cache steady state: the tower ran once up front (at
        # serving throughput, tools/torch_bench.py); each step takes the
        # precomputed [B, D] rows
        t0 = time.perf_counter()
        feats = train_step.image_features(params, pixels)
        float(torch.sum(feats))
        log(f"feature precompute (once per dataset pass): {time.perf_counter() - t0:.1f}s "
            f"for {batch} images")
        pixels = feats
    if pool_size:
        tokens = torch.from_numpy(rng.integers(0, pool_size, (batch,)).astype(np.int32)).to(
            device)
    else:
        tokens = torch.from_numpy(token_rows(batch)).to(device)

    t0 = time.perf_counter()
    loss, lora, opt_state = train_step(params, lora, opt_state, pixels, tokens)
    loss = float(loss)
    log(f"first step: {time.perf_counter() - t0:.1f}s loss={loss:.4f}")

    t0 = time.perf_counter()
    for _ in range(iters):
        loss, lora, opt_state = train_step(params, lora, opt_state, pixels, tokens)
        loss = float(loss)  # hard sync
    dt = (time.perf_counter() - t0) / iters
    log(f"{dt * 1e3:.1f} ms/step -> {batch / dt:.1f} img/s (train)")
    rec = {
        "metric": "train_images_per_sec_per_chip",
        "value": round(batch / dt, 1),
        "unit": "img/s",
        "batch": batch,
        "final_loss": round(loss, 4),
    }
    if cached:
        rec["cached_features"] = True
    if pool_size:
        rec["prompt_pool"] = pool_size
    if model != "vit_b_16":
        rec["model"] = config.name
    print(json.dumps(rec), flush=True)
    return [rec]


if __name__ == "__main__":
    main()
