#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``aiic_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each of which raises (and so exits non-zero) on failure:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. the Hopper kernels built with nvcc from ``aiic_tpu_torch/csrc``; the
   registers, spills and blocks per SM of the bf16 tensor-core core and the
   fp32 register-tiled core (each layout), of the two passes of the bf16
   tensor-core and the fp32 register-tiled core backward, of row 17's
   wgmma products and row pass, and of the wgmma GEMM stage of rows 1-5
   and 10 (per epilogue, row 3's folded c_proj among them) and of rows
   11-14 (per epilogue: the bf16 K-major B of the backward, row 14's folded
   dh2, the core backward's passes storing fp32);
3. each kernel against its plain PyTorch version on the card, at the
   serving paths' shapes (ViT-B/16 image and text half-blocks, B=1, an odd
   B, an all-zero LN row, the text tower's 52 prompts; rows 1 and 2 on the
   wgmma GEMM stage, row 2 and row 1's QKV stage bit for bit their WMMA
   forms, each bit for bit a second run, and the stage alone on each of the
   four products, the int8 ones bit for bit the WMMA stage; rows 5 and 10
   (bf16) on the same stage, row 5's core on the tensor-core core, each at
   the bf16 bar against its WMMA form and bit for bit a second run, and the
   stage alone on their three other products); the packed-QKV core in fp32 and bf16; the
   zoo's kernels: the chunked int8 MLP (row 3, on the wgmma stage with its
   chunk sums folded into c_proj) at the ViT-L/14 widths (C=2 and 4, a zero
   LN row) and at L/14@336 (C=4), each bit for bit its WMMA form; the whole
   int8 block (row 4: full at ViT-B/32 and at the text shapes with the
   causal mask; chunked at ViT-B/16 on (2, 4) and at L/14 on (1, 16)), each
   bit for bit row 1's form 0 followed by row 2's or row 3's form 0, its
   WMMA form bit for bit the WMMA rows in turn; the head-grouped core at
   S=577 (hg=8; hg=16 bit for bit the packed core); the attention-core ops no engine reaches: row 6
   (``flash_attention``) at ViT-B/16 (B=2 and 256), at the text shape
   (causal) and at D=8, row 9 (``fused_attention_qkv_bwd``: fp32 the
   register-tiled passes, bf16 the tensor-core passes; fp32's scalar forms
   beside, the streaming one bit for bit the one-tile kernel at S=77) at
   S=77 causal and S=197 for B = 1, 7, 64 and 256, both in fp32 and bf16;
   the bf16 tensor-core core
   of rows 7 and 8 at its tile edges (S = 1, 13, 63, 64, 65, 77 causal,
   197, 257, 577 at B = 1 and 3, a row the mask removes whole, which must
   be zero, and a row whose scores pass the clamp; row 8 at hg = 1, 8 and
   16, every group bit for bit the same and hg=16 bit for bit row 7's
   kernel); bf16 row 9 (the tensor-core backward) at its tile edges (S = 1,
   13, 63, 64, 65, 77 causal, 128, 129, 197, 257 at B = 1 and 3, rows the
   mask removes whole, a row whose scores pass the clamp; against its old
   one-tile form at S=77), fp32 row 9 (the register-tiled passes) at S = 1,
   13, 31, 32, 33, 63, 64, 65, 77 causal, 128, 129, 197, 257 at B = 1 and 3,
   removed and clamped rows, and bf16 row 6 (rows 7-8's core on separate q,
   k, v) at S = 1, 63, 65, 77 causal, 197 at B = 1 and 3, a removed row, a
   clamped row; fp32 rows 7 and 6 (the register-tiled core) at S = 1, 13,
   31, 32, 33, 63, 64, 65, 128, 129, 197, 257 at B = 1 and 3, 77 causal, 77
   and 130 with removed rows, 197 with a clamped row, row 6 bit for bit row
   7 and also at S=577, the scalar core it replaced beside where it fits;
   and
   the three tensor-core probe kernels (row 17, the wgmma form, and the
   WMMA form it replaced) at INNER=3 and at the probe's INNER=64; the
   kernel-experiment variants (rows 15-16: the 25
   variants of ``probes/variants.py``'s seven wrappers) at ViT-B/16, B = 2
   and 64 (and 1 for the two kernel_experiments.py functions, 1024 for the
   three kernel_experiments7.py variants), x with an all-zero row, form 0
   (the GEMM stage and the tensor-core variant core) counted and form 1
   (the WMMA design) beside, both maconly exact, the three
   kernel_experiments5.py schedules bit for bit row 1's form 0 and gelu2
   row 2's; each with the counts set to 0 before and exactly one launch
   after;
4. the paths: five full-width ViT-B/16 ``InteriorAnalyzer`` engines from
   one seeded init (int8 serving on the patch wire; the same with
   ``attn_impl="auto"``, which must launch exactly what the int8 engine
   does; bf16 unquantized, the worker's default; bf16 with
   ``attn_impl="pallas_mlp"``; fp32, the batch CLI's default; the last
   three on the HWC uint8 wire), each answering requests of 1, 7 and 64
   images with every kernel's launch count set to 0 before and checked
   exactly after against the launches that the copied JAX planners give
   each tower at each bucket (0 of rows 6, 9 and 17, as in the JAX
   package);
5. the same weights and 4 images through the int8 and the bf16 unquantized
   engines on the CPU (plain path): feature cosine, verdicts and top-1
   categories against the card;
6. the whole-text-block kernels of training (``text_block_fwd``,
   ``text_block_bwd``) against their plain versions at the B/16 text shape
   (S=77, W=512, M=2048, H=8, rank 16, causal mask, nonzero LoRA B) for
   B = 1, 7, 64 in fp32 and bf16; their int8 twins (``text_block_fwd_int8``,
   ``text_block_bwd_int8``) on per-channel-quantized weights at the same
   shape (unchunked plan) and at the L/14 text width (W=768, M=3072, H=12,
   B=7, the chunked plan, C=6); in bf16 and int8 (rows 11-14) form 0 (the
   products on the wgmma stage, the core forward on the tensor-core
   kernel, the rank-r products on rank_down_kernel / rank_cot_kernel, the
   core backward on row 9's tensor-core passes) beside form 1 (the first
   design: WMMA products, scalar cores, the 64x16 SIMT rank-r tile) at
   every case: form 1 against the plain version, form 0 against form 1 at
   the same bars, form 0 a second time bit for bit, form 0 launching the
   new kernels and none of the first design's; the tensor-core core
   forward alone against block_core_fwd_kernel at the bf16 bar; the rank-r
   kernels bit for bit narrow_gemm at every launch shape, fp32 and bf16;
   fp32 rows 11-12 launching the SIMT tile, the rank-r kernels and row 7's
   and row 9's register-tiled cores;
7. the LoRA trainer at full ViT-B/16 width through ``train_lora``, 2 epochs
   at batch 16 on a synthetic dataset of random 256x256 PNGs written to a
   temporary directory, on four paths: fp32 ``auto`` (which resolves to
   ``pallas_vjp``), fp32 ``block_fused``, bf16 ``block_fused`` and
   ``int8_text`` (``--attn-impl block_fused --quantize-text
   --quantize-image``: the int8 whole-block kernels), each with every launch
   count set to 0 before and checked exactly after; the loss finite, adapter
   B moved off zero, the ``.pth`` in the reference layout;
8. one train step of each path on the card against the same step on the CPU
   (plain versions), and ``block_fused`` against ``xla`` on the card; two
   int8 ``use_lora`` engines (the ``int8_text`` adapters of phase 7 at rank
   16; a seeded rank-4 ``c_fc``/``c_proj`` checkpoint, the analyzer's
   default) answering 1, 7 and 64 images with exact launch counts, their
   text features moved by the adapter and held against their CPU runs;
9. timings: each kernel against its plain version (serving kernels at B=256
   image rows, the text-block kernels at B=256 text rows in fp32, bf16 and
   int8), with its bound (rows 1, 2, 5 and 10 beside their WMMA forms
   timed right after them, the stage yardstick and device ms by stage of
   both forms, held against their plain versions; the GEMM stage alone on
   each of the seven products beside the WMMA stage and ``torch._int_mm`` /
   ``torch.matmul``; the int8, bf16 and bf16 ``pallas_mlp`` engines' 8-image
   calls launching the wgmma stage and the tensor-core core and no WMMA
   GEMM or scalar core; and the packed core against
   ``scaled_dot_product_attention``, in bf16 also at the L/14 shape B=256,
   S=257, W=1024, in fp32 also at 256 text rows, causal, and beside the
   scalar core it replaced; rows 7 and 8 held against their plain versions
   at the timed shapes, one counted launch each; every SDPA time, forward
   and backward, the median of 5 repeats with its spread); classify images/s at B=256 and
   single-image p50 latency of the int8, the bf16 unquantized and the bf16
   ``pallas_mlp`` engines;
   rows 11-14 at 256 text rows in bf16 and int8, form 0 again right
   before form 1, with both forms' device ms by stage; fp32 rows 11-12's
   device ms by stage and their stage yardstick (each product on the SIMT
   tile alone beside cuBLAS SGEMM with TF32 off); the rank-r products and
   the tensor-core core forward alone at 256 text rows beside their first
   designs (narrow_gemm, block_core_fwd_kernel), with their byte bounds;
   train-step ms at batch 256 (cached image features, dense text rows) on
   the four training paths; the steady-state images/s of a ``train_lora``
   epoch; row 6 at B=256 ViT-B/16 beside ``scaled_dot_product_attention``
   (fp32 also beside the scalar core it replaced);
   row 9 at 256 text rows and 256 ViT-B/16 images beside the autograd
   backward that ``pallas_vjp`` runs and SDPA's backward and beside the
   scalar forms its bf16 and fp32 forms replaced, with device ms by pass
   (bf16 row 6 and row 9 in both types held against their plain versions at
   the timed shapes); the fp32
   ``pallas_vjp`` step at 256 rows as shipped and with row 9 as its core
   backward (held to the shipped step at the fp32 step bar); the three
   probe kernels (wgmma) beside the WMMA form they replaced and
   ``torch.matmul`` / ``torch._int_mm``, held against their plain
   versions, with device ms by stage; each
   kernel-experiment variant, one launch at B=256, beside its plain version
   with its bound (no PyTorch call computes any of them), its form 1 timed
   right after form 0, both forms' device ms by stage from whole
   ``torch.profiler`` traces (form 0 launching the stage and, where the
   variant has a core, the variant core, and no WMMA GEMM or scalar core),
   and that launch's output held against the plain version at phase 3's
   bars;
10. the zoo: full-width, full-depth engines from one seeded init per preset
   (int8 ViT-B/32, ViT-L/14 and ViT-L/14@336 on the patch wire; bf16 L/14
   and L/14@336 and fp32 L/14@336 on the HWC wire), each answering 1, 7 and
   64 images with exact launch counts as in phase 4; each against its CPU
   run on 2 images; each int8 engine's image features against the bf16
   ``attn_impl="xla"`` path on the card (the twin of
   ``tools/zoo_cosine.py``); then the zoo kernels timed at B=256 (row 3 at
   L/14 and L/14@336, row 4 at B/32 and at the text tower's 52 prompts, each
   held against its plain version and beside its WMMA form and the stage
   yardstick; both forms' device ms by stage, form 0 on the wgmma stage
   alone and bit for bit its WMMA form (row 4: rows 1 and 2 in turn);
   row 3's folded c_proj
   alone beside ``torch._int_mm``, both forms' peak memory; row 8 at
   L/14@336 beside ``scaled_dot_product_attention``); each int8 engine's
   8-image call launching the wgmma stage and no WMMA GEMM or chunk-sum
   pass; images/s at B=256 and single-image p50 of the three int8 engines;
11. this slice's path: rows 6, 9 and 17 through the entry points a user
   calls (``flash_attention`` on 256 ViT-B/16 images in fp32 and bf16,
   ``fused_attention_qkv_bwd`` on 256 text rows and 256 ViT-B/16 images in
   fp32 and bf16,
   ``python -m aiic_tpu_torch.probes.mxu_probe 5``'s run), every count set
   to 0 before and checked exactly after;
12. rows 15-16's path: ``kernel_experiments.run_experiment`` (``python -m
   aiic_tpu_torch.probes.kernel_experiments N``) for experiments 1-5 and 7
   at the tools' batches (256; 1024 for 7), one timed stack a variant, the
   int8 classify program at B=256 and 512 in experiment 1, every count set
   to 0 before and checked exactly after (12 launches a 12-layer stack, 11
   of rows 1 and 2 a classify call), each REAL candidate's cosine against
   prod finite; each variant's stack time against prod's (``prod -
   ablation``: rows 1-2's time by pass, both on one design);
13. the serving surface: the worker's REST app built as ``python -m
   aiic_tpu_torch.cli.worker --serve`` builds it (its parser, ``EngineArgs.
   build_analyzer``, ``build_serving_app`` on a free port) at full ViT-B/16
   width and depth from one seeded init (made on the CPU, loaded through
   ``--weights``), in the worker's default
   configuration (bf16, HWC wire, max batch 64, pipeline depth 2: row 5)
   and with ``--dtype bfloat16 --quantize --wire-format patch`` (rows 1, 2
   and 4), each with every count set to 0 before the engine is built and
   the launches checked exactly at build (the text tower), after the warmup
   of buckets 1-64, after 20 sequential single-image ``POST /analyze``,
   after one ``POST /analyze-batch`` of 64 images and after a burst of 64
   single-image requests from 16 client threads (per batch the batcher
   reports in /metrics' batch-size histogram); every answer held against
   the same engine's ``classify_pixels`` on the same decoded pixels, 4
   images against the CPU plain path as in phase 5, an undecodable image's
   error answer, ``GET /health``, ``/ready``, ``/metrics`` (the stage
   timings) and ``/dead-letters``; single-image p50/p90 and requests/s,
   burst and batch images/s with their batch sizes, the decoder that
   served; then ``process_apartments_pipeline`` on an ``InMemoryDB`` of two
   apartments of 4 local images and one unreadable path on the bf16 engine
   (exact launches, statuses, the failed attempt, the export); then ``python
   -m aiic_tpu_torch.cli.worker --serve`` as a process with default flags,
   ready within a bound, one ``POST /analyze`` and ``GET /metrics``, exit
   code 0 on SIGTERM;
14. dataset evaluation, from one CPU-seeded ViT-B/16 init at full width and
   depth and 32 synthetic 224-288 px JPEGs and PNGs labelled from the
   two-item vocabulary (an ``interior_dataset.json``): ``train.metrics.
   attribute_f1`` on the int8 worker configuration (rows 1, 2 and 4) and the
   bf16 worker default (row 5), every count set to 0 before the engine is
   built and checked exactly at build and after the call, each against the
   same call on the CPU plain path (every attribute score within
   SCORE_TOL, the decisions equal up to logged swaps of two attributes
   closer than SWAP_TOL on the CPU); ``tools/torch_eval_f1.py --limit 16``
   as a process, its JSON equal to the in-process call on the fp32 engine it
   builds (row 7, exact launches); the serving configuration's and the fp32
   configuration's 40 detector-prompt logits on the card (rows 1, 2 and 4;
   row 7; exact launches) against the port's fp32 plain path on the CPU
   (logit cosine >= 0.999, fp32 verdicts equal, each disagreeing image
   logged with its interior mass on both sides); ``tools/
   torch_parity_report.py`` as a process in fp32 and in the serving
   configuration against its seeded ``transformers.CLIPModel`` oracle
   (``passes_0999_bar``); ``models.clip_forward`` in fp32 on 8 images and
   the 40 prompts (row 7 exactly 23 times) against the CPU (row cosine >=
   0.999, argmax per row equal); bf16 ``encode_image`` on
   ``adapters.fold_visual_lora``'s params (row 5) with a seeded rank-4 tree
   against the CPU, and a zero-B fold bit for bit the unfolded features.
   The three tool processes run beside the in-process parts.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. A longer report goes to
``chiprun_out/chip_smoke.json``.
No JAX is imported; nothing falls back to the CPU when CUDA is missing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPORT: dict = {}
T0 = time.perf_counter()

# A kernel agrees with its plain version when every row's cosine is at least
# COS_MIN and at least ULP_SHARE of the elements lie within 2 bf16 ULPs of the
# plain value: the two differ only where a summation order moves an fp32
# value across a bf16 or int8 rounding boundary.
# In fp32 a kernel agrees when max |kernel - plain| / max(|plain|, 1) is at
# most F32_REL: only the order of fp32 sums differs.
# The text-block kernels (training) round eleven intermediates to bf16 on
# the way from x to y or dx (qkv, p, a, h2, u; dfq, dy1, da, ds, dqkv and the
# rank-r products); where a later sum cancels, a flipped rounding upstream
# costs a few ULPs of the terms, not of the smaller result. Their bf16 bar is
# therefore per row: cosine >= COS_MIN and every element within 2 bf16 ULPs
# of the row's largest |plain| value.
# The int8 text-block kernels (training in the int8 serving numerics) are
# held to the same per-row bar for y; dx to a row cosine >= COS_MIN alone: an
# int8 quantum that flips between kernel and plain (their fp32 LN and core
# sums differ in order, so one activation can round to the other integer)
# moves a whole row of a cotangent product by that quantum's weight row, a
# cancellation-free shift far above 2 ULPs of small dx entries but a few
# 1e-6 of the row's cosine; each LoRA cotangent to a cosine >= COS_MIN.
COS_MIN = 0.9999
ULP_SHARE = 0.99
F32_REL = 1e-5

KERNELS = {
    "int8_ln_qkv_attention": {
        "source": "aiic_tpu_torch/csrc/int8_attention.cu",
        "replaces": "aiic_tpu/ops/quant.py:353",
    },
    "int8_ln_mlp": {
        "source": "aiic_tpu_torch/csrc/int8_mlp.cu",
        "replaces": "aiic_tpu/ops/quant.py:102",
    },
    # The wgmma + TMA GEMM stage of rows 1-4 (their products).
    "gemm_stage": {
        "source": "aiic_tpu_torch/csrc/wgmma_serving_gemm.cuh",
        "replaces": "aiic_tpu/ops/quant.py:353, :102 and :190",
    },
    # Rows 5 and 10 run their products on the GEMM stage, row 5 its core on
    # the tensor-core core.
    "fused_ln_qkv_attention": {
        "source": "aiic_tpu_torch/csrc/ln_qkv_attention.cu",
        "sources": ["aiic_tpu_torch/csrc/ln_qkv_attention.cu",
                    "aiic_tpu_torch/csrc/wgmma_serving_gemm.cuh",
                    "aiic_tpu_torch/csrc/attn_core_mma.cuh"],
        "replaces": "aiic_tpu/ops/attention.py:133",
    },
    "fused_attention_qkv": {
        "source": "aiic_tpu_torch/csrc/attn_core_f32.cuh",
        "replaces": "aiic_tpu/ops/attention.py:426",
    },
    "fused_ln_mlp": {
        "source": "aiic_tpu_torch/csrc/ln_mlp.cu",
        "sources": ["aiic_tpu_torch/csrc/ln_mlp.cu", "aiic_tpu_torch/csrc/wgmma_serving_gemm.cuh"],
        "replaces": "aiic_tpu/ops/mlp.py:27",
    },
    # Rows 11-14: the entries of rows 11-12 are their fp32 (CLI default)
    # route (the SIMT tile, the rank-r kernels, row 7's and row 9's
    # register-tiled cores); in bf16 and int8 the backbone products run on
    # the GEMM stage, the core forward on the tensor-core kernel and the
    # backward's core on row 9's tensor-core passes.
    "text_block_fwd": {
        "source": "aiic_tpu_torch/csrc/text_block.cuh",
        "sources": ["aiic_tpu_torch/csrc/text_block.cuh",
                    "aiic_tpu_torch/csrc/attn_core_f32.cuh",
                    "aiic_tpu_torch/csrc/wgmma_serving_gemm.cuh",
                    "aiic_tpu_torch/csrc/block_core_fwd_mma.cuh"],
        "replaces": "aiic_tpu/ops/block_grad.py:322 and :388",
    },
    "text_block_bwd": {
        "source": "aiic_tpu_torch/csrc/text_block.cuh",
        "sources": ["aiic_tpu_torch/csrc/text_block.cuh",
                    "aiic_tpu_torch/csrc/attn_core_f32.cuh",
                    "aiic_tpu_torch/csrc/attn_core_bwd_f32.cuh",
                    "aiic_tpu_torch/csrc/wgmma_serving_gemm.cuh",
                    "aiic_tpu_torch/csrc/block_core_fwd_mma.cuh",
                    "aiic_tpu_torch/csrc/attn_core_bwd_mma.cuh"],
        "replaces": "aiic_tpu/ops/block_grad.py:198 and :472",
    },
    "text_block_fwd_int8": {
        "source": "aiic_tpu_torch/csrc/text_block_int8.cu",
        "sources": ["aiic_tpu_torch/csrc/text_block_int8.cu",
                    "aiic_tpu_torch/csrc/wgmma_serving_gemm.cuh",
                    "aiic_tpu_torch/csrc/block_core_fwd_mma.cuh"],
        "replaces": "aiic_tpu/ops/block_grad.py:1084 and :1433",
    },
    "text_block_bwd_int8": {
        "source": "aiic_tpu_torch/csrc/text_block_int8.cu",
        "sources": ["aiic_tpu_torch/csrc/text_block_int8.cu",
                    "aiic_tpu_torch/csrc/wgmma_serving_gemm.cuh",
                    "aiic_tpu_torch/csrc/block_core_fwd_mma.cuh",
                    "aiic_tpu_torch/csrc/attn_core_bwd_mma.cuh"],
        "replaces": "aiic_tpu/ops/block_grad.py:1104 and :1542",
    },
    "int8_ln_mlp_chunked": {
        "source": "aiic_tpu_torch/csrc/int8_mlp.cu",
        "replaces": "aiic_tpu/ops/quant.py:190",
    },
    "int8_block": {
        "source": "aiic_tpu_torch/csrc/int8_block.cu",
        "replaces": "aiic_tpu/ops/quant.py:673 and :782",
    },
    "fused_attention_qkv_headgroups": {
        "source": "aiic_tpu_torch/csrc/attn_core_mma.cuh",
        "replaces": "aiic_tpu/ops/attention.py:563",
    },
    "fused_attention": {
        "source": "aiic_tpu_torch/csrc/attn_core_f32.cuh",
        "replaces": "aiic_tpu/ops/attention.py:313",
    },
    "fused_attention_qkv_bwd": {
        "source": "aiic_tpu_torch/csrc/attn_core_bwd_f32.cuh",
        "replaces": "aiic_tpu/ops/attention.py:728",
    },
    "mxu_bf16": {
        "source": "aiic_tpu_torch/csrc/mxu_probe_wgmma.cu",
        "replaces": "tools/mxu_probe.py:38",
    },
    "mxu_i8": {
        "source": "aiic_tpu_torch/csrc/mxu_probe_wgmma.cu",
        "replaces": "tools/mxu_probe.py:51",
    },
    "mxu_i8_quant": {
        "source": "aiic_tpu_torch/csrc/mxu_probe_wgmma.cu",
        "replaces": "tools/mxu_probe.py:62",
    },
    # The kernel-experiment variants (rows 15-16): one wrapper per TPU function,
    # form 0 (the C entries in attn_variants.cu / mlp_variants.cu, form 1
    # beside them).
    "int8_attn_nomax": {
        "source": "aiic_tpu_torch/csrc/attn_variants_wgmma.cu",
        "replaces": "tools/kernel_experiments.py:92",
    },
    "mlp_var": {
        "source": "aiic_tpu_torch/csrc/mlp_variants_wgmma.cu",
        "replaces": "tools/kernel_experiments.py:163",
    },
    "attn_var2": {
        "source": "aiic_tpu_torch/csrc/attn_variants_wgmma.cu",
        "replaces": "tools/kernel_experiments2.py:55",
    },
    "mlp_var3": {
        "source": "aiic_tpu_torch/csrc/mlp_variants_wgmma.cu",
        "replaces": "tools/kernel_experiments3.py:67",
    },
    "attn_var4": {
        "source": "aiic_tpu_torch/csrc/attn_variants_wgmma.cu",
        "replaces": "tools/kernel_experiments4.py:68",
    },
    "attn_var5": {
        "source": "aiic_tpu_torch/csrc/attn_variants_wgmma.cu",
        "replaces": "tools/kernel_experiments5.py:55",
    },
    "attn_var7": {
        "source": "aiic_tpu_torch/csrc/attn_variants_wgmma.cu",
        "replaces": "tools/kernel_experiments7.py:107",
    },
}

# NVIDIA H100 SXM5 data sheet: dense peaks by operand type, and HBM3.
PEAK_OPS = {"bf16": 989.4e12, "int8": 1978.9e12, "fp32": 66.9e12}
HBM_BYTES_PER_S = 3.35e12

# The serving configurations: engine options.
CONFIGS = {
    "int8": dict(dtype="bfloat16", quantize=True, wire_format="patch", attn_impl="pallas"),
    "bf16": dict(dtype="bfloat16", quantize=False, wire_format="hwc", attn_impl="pallas"),
    "bf16_pallas_mlp": dict(dtype="bfloat16", quantize=False, wire_format="hwc",
                            attn_impl="pallas_mlp"),
    "fp32": dict(dtype="float32", quantize=False, wire_format="hwc", attn_impl="pallas"),
    # the JAX engine's default attn_impl: on the card it must be the int8 path
    "int8_auto": dict(dtype="bfloat16", quantize=True, wire_format="patch", attn_impl="auto"),
}
# The paths of phase 4 (ViT-B/16) and of the zoo (phase 10): configuration, preset.
PATHS = {label: (label, "VIT_B_16") for label in CONFIGS}
ZOO_PATHS = {  # in preset order: one seeded init per preset
    "int8_b32": ("int8", "VIT_B_32"),
    "int8_l14": ("int8", "VIT_L_14"),
    "bf16_l14": ("bf16", "VIT_L_14"),
    "int8_l14_336": ("int8", "VIT_L_14_336"),
    "bf16_l14_336": ("bf16", "VIT_L_14_336"),
    "fp32_l14_336": ("fp32", "VIT_L_14_336"),
}
# tools/zoo_cosine.py's bar: an int8 engine's image features against the
# bf16 reference composition (attn_impl="xla") on the same weights.
ZOO_COS_MIN = 0.999

# The vocabulary of tests/test_engine.py's engine fixture.
TRAINING_DATA = [
    {"image_path": "x.jpg", "style": "nowoczesny",
     "characteristics": ["czyste linie", "przestronne"], "materials": ["drewno"],
     "colors": ["biały", "szary"], "room_type": "kuchnia"},
    {"image_path": "y.jpg", "style": "klasyczny", "characteristics": ["eleganckie"],
     "materials": ["marmur"], "colors": ["beżowy"], "room_type": "salon"},
]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _half_block_inputs(rng, bsz, seq, width, heads, *, mask, zero_row, device):
    import torch

    from aiic_tpu_torch.models.clip import causal_mask
    from aiic_tpu_torch.ops.quant import quantize_weight

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dtype)

    mlp = 4 * width
    x = rng.standard_normal((bsz, seq, width))
    ln_b = 0.1 * rng.standard_normal(width)
    if zero_row:  # all-zero LN output row: exercises the 1e-6 scale floor
        x[0, 0] = 0.0
        ln_b[:] = 0.0
    proj_std = width ** -0.5 * 24 ** -0.5
    p = {
        "x": t(x, torch.bfloat16),
        "ln_s": t(1 + 0.1 * rng.standard_normal(width)),
        "ln_b": t(ln_b),
        "wqkv": t(rng.standard_normal((width, 3 * width)) * width ** -0.5),
        "bqkv": t(0.1 * rng.standard_normal(3 * width)),
        "wo": t(rng.standard_normal((width, width)) * proj_std, torch.bfloat16),
        "bo": t(0.1 * rng.standard_normal(width)),
        "w1": t(rng.standard_normal((width, mlp)) * (2 * width) ** -0.5),
        "b1": t(0.1 * rng.standard_normal(mlp)),
        "w2": t(rng.standard_normal((mlp, width)) * proj_std),
        "b2": t(0.1 * rng.standard_normal(width)),
        "mask": causal_mask(seq, device=device) if mask else None,
        "heads": heads,
    }
    p["wqkv_q"], p["sqkv"] = quantize_weight(p["wqkv"])
    p["w1_q"], p["s1"] = quantize_weight(p["w1"])
    p["w2_q"], p["s2"] = quantize_weight(p["w2"])
    for k in ("wqkv", "w1", "w2"):  # the bf16 kernels' weights, cast once
        p[k + "_b"] = p[k].to(torch.bfloat16)
    p["qkv"] = t(rng.standard_normal((bsz, seq, 3 * width)))
    p["qkv_b"] = p["qkv"].to(torch.bfloat16)
    return p


def _calls(p):
    """check name -> (kernel wrapper call, plain call, tensors the kernel
    reads, ops by operand type) on one input set. The packed core runs fp32
    on the fp32 path and is held in bf16 too."""
    from aiic_tpu_torch.ops import attention, mlp, quant

    bsz, seq, width = p["x"].shape
    heads, mlp_dim = p["heads"], p["w1"].shape[-1]
    rows, dim = bsz * seq, width // heads
    core = 4 * bsz * heads * seq * seq * dim  # Q.K^T and p.V
    attn_q = (p["x"], p["ln_s"], p["ln_b"], p["wqkv_q"], p["sqkv"], p["bqkv"], p["wo"], p["bo"],
              p["mask"])
    mlp_q = (p["x"], p["ln_s"], p["ln_b"], p["w1_q"], p["s1"], p["b1"], p["w2_q"], p["s2"],
             p["b2"])
    attn_b = (p["x"], p["ln_s"], p["ln_b"], p["wqkv_b"], p["bqkv"], p["wo"], p["bo"], p["mask"])
    mlp_b = (p["x"], p["ln_s"], p["ln_b"], p["w1_b"], p["b1"], p["w2_b"], p["b2"])
    h = dict(heads=heads)
    return {
        "int8_ln_qkv_attention": (
            lambda: quant.int8_ln_qkv_attention(*attn_q, **h),
            lambda: quant.int8_ln_qkv_attention_ref(*attn_q, **h), attn_q,
            {"int8": 2 * rows * width * 3 * width, "bf16": core + 2 * rows * width * width}),
        "int8_ln_mlp": (
            lambda: quant.int8_ln_mlp(*mlp_q), lambda: quant.int8_ln_mlp_ref(*mlp_q), mlp_q,
            {"int8": 4 * rows * width * mlp_dim}),
        "fused_ln_qkv_attention": (
            lambda: attention.fused_ln_qkv_attention(*attn_b, **h),
            lambda: attention.fused_ln_qkv_attention_ref(*attn_b, **h), attn_b,
            {"bf16": 2 * rows * width * 4 * width + core}),
        "fused_attention_qkv": (
            lambda: attention.fused_attention_qkv(p["qkv"], p["mask"], **h),
            lambda: attention.fused_attention_qkv_ref(p["qkv"], p["mask"], heads),
            (p["qkv"], p["mask"]), {"fp32": core}),
        "fused_attention_qkv_bf16": (
            lambda: attention.fused_attention_qkv(p["qkv_b"], p["mask"], **h),
            lambda: attention.fused_attention_qkv_ref(p["qkv_b"], p["mask"], heads),
            (p["qkv_b"], p["mask"]), {"bf16": core}),
        "fused_ln_mlp": (
            lambda: mlp.fused_ln_mlp(*mlp_b), lambda: mlp.fused_ln_mlp_ref(*mlp_b), mlp_b,
            {"bf16": 4 * rows * width * mlp_dim}),
    }


def _stage_products(p) -> dict:
    """The four products of rows 1 and 2 for the GEMM stage alone
    (``quant.gemm_stage``): name -> (a, w, epilogue, keywords, ops), on
    operands made from one input set by the plain pieces: hq, hs = the row
    quantizer of LN(x); qkv and y = the plain stage; attn = the plain core
    of qkv; yq, ys = the row quantizer of y."""
    from aiic_tpu_torch.ops import attention, quant

    x = p["x"]
    bsz, seq, width = x.shape
    rows, mlp_dim = bsz * seq, p["w1"].shape[-1]
    xr = x.reshape(rows, width)
    h = attention._ln_fp32(x.float().reshape(rows, width), p["ln_s"].reshape(1, width),
                           p["ln_b"].reshape(1, width), 1e-5)
    hq, hs = quant._row_quant(h)
    qkv_kw = dict(row_scale=hs, col_scale=p["sqkv"], bias=p["bqkv"])
    fc_kw = dict(row_scale=hs, col_scale=p["s1"], bias=p["b1"])
    qkv = quant.gemm_stage_ref(hq, p["wqkv_q"], "qkv", **qkv_kw)
    attn = attention.fused_attention_qkv_ref(qkv.reshape(bsz, seq, 3 * width), p["mask"],
                                             p["heads"]).reshape(rows, width)
    yq, ys = quant._row_quant(quant.gemm_stage_ref(hq, p["w1_q"], "gelu", **fc_kw))
    return {
        "gemm_stage_qkv": (hq, p["wqkv_q"], "qkv", qkv_kw, {"int8": 2 * rows * width * 3 * width}),
        "gemm_stage_c_fc": (hq, p["w1_q"], "gelu", fc_kw, {"int8": 2 * rows * width * mlp_dim}),
        "gemm_stage_c_proj": (yq, p["w2_q"], "residual",
                              dict(row_scale=ys, col_scale=p["s2"], bias=p["b2"], x=xr),
                              {"int8": 2 * rows * mlp_dim * width}),
        "gemm_stage_out_proj": (attn, p["wo"], "out_proj", dict(bias=p["bo"], x=xr),
                                {"bf16": 2 * rows * width * width}),
    }


def _bf16_stage_products(p) -> dict:
    """The products of rows 5 and 10 that row 1's out-projection does not
    already stand for, for the GEMM stage alone, as ``_stage_products``: h =
    bf16(LN(x)); row 5's QKV product with its bias (``bias``), row 10's c_fc
    with its bias and gelu (``bias_gelu``), and its c_proj (``out_proj`` at
    K = 4W) on y = the plain c_fc."""
    import torch

    from aiic_tpu_torch.ops import attention, quant

    x = p["x"]
    bsz, seq, width = x.shape
    rows, mlp_dim = bsz * seq, p["w1"].shape[-1]
    h = attention._ln_fp32(x.float().reshape(rows, width), p["ln_s"].reshape(1, width),
                           p["ln_b"].reshape(1, width), 1e-5).to(torch.bfloat16)
    fc_kw = dict(bias=p["b1"])
    y = quant.gemm_stage_ref(h, p["w1_b"], "bias_gelu", **fc_kw)
    return {
        "gemm_stage_bf16_qkv": (h, p["wqkv_b"], "bias", dict(bias=p["bqkv"]),
                                {"bf16": 2 * rows * width * 3 * width}),
        "gemm_stage_bf16_c_fc": (h, p["w1_b"], "bias_gelu", fc_kw,
                                 {"bf16": 2 * rows * width * mlp_dim}),
        "gemm_stage_bf16_c_proj": (y, p["w2_b"], "out_proj",
                                   dict(bias=p["b2"], x=x.reshape(rows, width)),
                                   {"bf16": 2 * rows * mlp_dim * width}),
    }


def _stage_calls(products) -> dict:
    """check name -> (kernel call, plain call, tensors the kernel reads, ops)
    of each product of ``_stage_products``."""
    from aiic_tpu_torch.ops import quant

    return {name: (lambda a=a, w=w, e=e, kw=kw: quant.gemm_stage(a, w, e, **kw),
                   lambda a=a, w=w, e=e, kw=kw: quant.gemm_stage_ref(a, w, e, **kw),
                   (a, w) + tuple(kw.values()), ops)
            for name, (a, w, e, kw, ops) in products.items()}


def _stage_wmma(product):
    """One product of ``_stage_products`` on the WMMA gemm_kernel the stage
    replaced (``_gemm_stage_cuda(form="wmma")``, uncounted)."""
    from aiic_tpu_torch.ops import quant

    a, w, e, kw, _ = product
    return quant._gemm_stage_cuda(a, w, e, kw.get("row_scale"), kw.get("col_scale"), kw["bias"],
                                  kw.get("x"), "wmma")


def _stage_library(product):
    """The stage yardstick of one product: ``torch._int_mm`` of the int8
    operands (w^T read column-major, the layout its fast kernels take), or
    ``torch.matmul`` of the bf16 ones; no epilogue."""
    import torch

    from aiic_tpu_torch.ops import quant

    a, w, e, _, _ = product
    if e in quant.BF16_EPILOGUES:
        return lambda: torch.matmul(a, w)
    wt = quant.kmajor(w)
    return lambda: torch._int_mm(a, wt.t())


def _bound(inputs, out, ops) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, the output written once) over HBM bandwidth and
    the operations over the peak rate of their operand type."""
    import torch

    nbytes = sum(t.nbytes for t in inputs if isinstance(t, torch.Tensor)) + out.nbytes
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = sum(n / PEAK_OPS[kind] for kind, n in ops.items()) * 1e3
    return {"bound_ms": max(mem_ms, ops_ms), "bound_by": "operations" if ops_ms >= mem_ms else "bytes",
            "bytes": nbytes, "ops": ops}


def _ulp(v):
    import torch

    return torch.exp2(torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -126))) - 7)


def _agreement(out, ref, row_scale: bool = False) -> dict:
    """Agreement with the plain version and whether it passes: the bf16 bar
    for bf16 outputs (per row for the text-block kernels, ``row_scale``),
    the fp32 bar for fp32 ones."""
    import torch

    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    err = (o - r).abs()
    cos = torch.nn.functional.cosine_similarity(o, r, dim=-1)
    row_ulp = _ulp(r.abs().amax(dim=-1, keepdim=True))
    a = {
        "dtype": str(out.dtype).replace("torch.", ""),
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / r.abs().clamp(min=1.0)).max()),
        "within_2ulp": float((err <= 2 * _ulp(r)).float().mean()),
        "max_err_in_row_max_ulps": float((err / row_ulp).max()),
        "min_row_cos": float(cos.min()),
        "finite": bool(torch.isfinite(o).all()),
    }
    if out.dtype == torch.float32:
        a["ok"] = a["finite"] and a["max_rel_err"] <= F32_REL
    elif row_scale:
        a["ok"] = (a["finite"] and a["min_row_cos"] >= COS_MIN
                   and a["max_err_in_row_max_ulps"] <= 2)
    else:
        a["ok"] = a["finite"] and a["min_row_cos"] >= COS_MIN and a["within_2ulp"] >= ULP_SHARE
    return a


def _hold_forms(p, label: str, results: list, worst: dict) -> None:
    """Phase 3 for rows 1 and 2 beside the WMMA forms they replaced: row 2
    bit for bit its WMMA form, row 1's QKV stage bit for bit the WMMA stage,
    each row bit for bit a second run of itself, the WMMA form of row 1
    against the plain version (recorded); then the GEMM stage alone on each
    of the four products (``_hold_stage_products``)."""
    import torch

    from aiic_tpu_torch.ops import quant

    h = p["heads"]
    attn_q = (p["x"], p["ln_s"], p["ln_b"], p["wqkv_q"], p["sqkv"], p["bqkv"], p["wo"], p["bo"],
              p["mask"])
    mlp_q = (p["x"], p["ln_s"], p["ln_b"], p["w1_q"], p["s1"], p["b1"], p["w2_q"], p["s2"],
             p["b2"])
    new2, again2 = quant.int8_ln_mlp(*mlp_q), quant.int8_ln_mlp(*mlp_q)
    old2 = quant._int8_ln_mlp_cuda(*mlp_q, 1e-5, 1, "wmma")
    new1 = quant.int8_ln_qkv_attention(*attn_q, heads=h)
    again1 = quant.int8_ln_qkv_attention(*attn_q, heads=h)
    old1 = quant._int8_ln_qkv_attention_cuda(*attn_q, h, 1e-5, "wmma")
    qkv_new = quant._int8_qkv(*attn_q[:6], 1e-5)
    qkv_old = quant._int8_qkv(*attn_q[:6], 1e-5, "wmma")
    torch.cuda.synchronize()
    r = {"kernel": "int8 rows 1-2 forms", "case": label,
         "row2_bit_identical_to_wmma": bool(torch.equal(new2, old2)),
         "row2_repeat_bit_identical": bool(torch.equal(new2, again2)),
         "row1_qkv_stage_bit_identical_to_wmma": bool(torch.equal(qkv_new, qkv_old)),
         "row1_repeat_bit_identical": bool(torch.equal(new1, again1)),
         "row1_wmma_vs_plain": _agreement(old1, quant.int8_ln_qkv_attention_ref(*attn_q, heads=h))}
    results.append(r)
    flags = {k: v for k, v in r.items() if k.endswith("identical") or k.endswith("wmma")}
    log(f"[kernels] rows 1-2 forms {label:20s} {flags}; the WMMA form of row 1 vs plain "
        f"min_row_cos={r['row1_wmma_vs_plain']['min_row_cos']:.8f}")
    if not all(flags.values()):
        raise AssertionError(f"rows 1-2 on {label}: {r}")
    _hold_stage_products(_stage_products(p), label, results, worst)


def _hold_bf16_forms(p, label: str, results: list, worst: dict) -> None:
    """Phase 3 for rows 5 and 10 beside the WMMA forms they replaced: each
    row's form 0 (the route) against its form 1 at the bf16 bar (the two sum
    fp32 in different orders) and bit for bit a second run of itself; then
    the stage alone on row 5's QKV product and row 10's two against their
    plain versions."""
    import torch

    from aiic_tpu_torch.ops import attention, mlp

    h = p["heads"]
    attn_b = (p["x"], p["ln_s"], p["ln_b"], p["wqkv_b"], p["bqkv"], p["wo"], p["bo"], p["mask"])
    mlp_b = (p["x"], p["ln_s"], p["ln_b"], p["w1_b"], p["b1"], p["w2_b"], p["b2"])
    new5 = attention.fused_ln_qkv_attention(*attn_b, heads=h)
    again5 = attention.fused_ln_qkv_attention(*attn_b, heads=h)
    old5 = attention._fused_ln_qkv_attention_cuda(*attn_b, h, 1e-5, "wmma")
    new10, again10 = mlp.fused_ln_mlp(*mlp_b), mlp.fused_ln_mlp(*mlp_b)
    old10 = mlp._fused_ln_mlp_cuda(*mlp_b, 1e-5, "wmma")
    torch.cuda.synchronize()
    r = {"kernel": "bf16 rows 5 and 10 forms", "case": label,
         "row5_repeat_bit_identical": bool(torch.equal(new5, again5)),
         "row10_repeat_bit_identical": bool(torch.equal(new10, again10)),
         "row5_vs_wmma": _agreement(new5, old5), "row10_vs_wmma": _agreement(new10, old10)}
    results.append(r)
    ok = (r["row5_repeat_bit_identical"] and r["row10_repeat_bit_identical"]
          and r["row5_vs_wmma"]["ok"] and r["row10_vs_wmma"]["ok"])
    log(f"[kernels] rows 5, 10 forms {label:20s} repeats bit for bit "
        f"{r['row5_repeat_bit_identical']}, {r['row10_repeat_bit_identical']}; form 0 vs the "
        f"WMMA form min_row_cos {r['row5_vs_wmma']['min_row_cos']:.8f}, "
        f"{r['row10_vs_wmma']['min_row_cos']:.8f}, within_2ulp "
        f"{r['row5_vs_wmma']['within_2ulp']:.6f}, {r['row10_vs_wmma']['within_2ulp']:.6f}")
    if not ok:
        raise AssertionError(f"rows 5 and 10 on {label}: {r}")
    _hold_stage_products(_bf16_stage_products(p), label, results, worst)


def _hold_stage_products(products: dict, label: str, results: list, worst: dict) -> None:
    """The GEMM stage alone on each product against its plain version, the
    int8 ones also bit for bit the WMMA stage. ``worst["gemm_stage"]`` takes
    the stage's largest error."""
    import torch

    from aiic_tpu_torch.ops import quant

    for name, prod in products.items():
        kernel, plain, _, _ = _stage_calls({name: prod})[name]
        out, wmma = kernel(), _stage_wmma(prod)
        torch.cuda.synchronize()
        a = _agreement(out, plain())
        if prod[2] not in quant.BF16_EPILOGUES:
            a["bit_identical_to_wmma"] = bool(torch.equal(out, wmma))
            a["ok"] = a["ok"] and a["bit_identical_to_wmma"]
        a.update(kernel="gemm_stage", product=name, case=label)
        results.append(a)
        log(f"[kernels] {name:24s} {label:20s} {a['dtype']:8s} max_abs_err={a['max_abs_err']:.6g} "
            f"within_2ulp={a['within_2ulp']:.6f} min_row_cos={a['min_row_cos']:.8f}"
            + (f" bit_identical_to_wmma={a['bit_identical_to_wmma']}"
               if "bit_identical_to_wmma" in a else ""))
        if not a["ok"]:
            raise AssertionError(f"{name} disagrees on {label}: {a}")
        worst["gemm_stage"] = max(worst.get("gemm_stage", 0.0), a["max_abs_err"])
        del out, wmma


def phase_kernels(device) -> dict:
    import torch

    cases = [
        ("image B=8", dict(bsz=8, seq=197, width=768, heads=12, mask=False, zero_row=False)),
        ("text B=48 causal", dict(bsz=48, seq=77, width=512, heads=8, mask=True, zero_row=False)),
        ("image B=1", dict(bsz=1, seq=197, width=768, heads=12, mask=False, zero_row=False)),
        ("image B=3", dict(bsz=3, seq=197, width=768, heads=12, mask=False, zero_row=False)),
        ("image B=2 zero row", dict(bsz=2, seq=197, width=768, heads=12, mask=False, zero_row=True)),
        # the bf16 text tower's build shape: the vocabulary's 52 prompts
        ("text B=52 causal", dict(bsz=52, seq=77, width=512, heads=8, mask=True, zero_row=False)),
    ]
    rng = np.random.default_rng(0)
    worst = {}
    results = []
    for label, kw in cases:
        p = _half_block_inputs(rng, device=device, **kw)
        for name, (kernel, plain, _, _) in _calls(p).items():
            out = kernel()
            torch.cuda.synchronize()
            ref = plain()
            a = _agreement(out, ref)
            a.update(kernel=name, case=label)
            results.append(a)
            log(f"[kernels] {name:24s} {label:20s} {a['dtype']:8s} max_abs_err={a['max_abs_err']:.6g} "
                f"max_rel_err={a['max_rel_err']:.3g} within_2ulp={a['within_2ulp']:.6f} "
                f"min_row_cos={a['min_row_cos']:.8f}")
            if not a["ok"]:
                raise AssertionError(f"{name} disagrees with its plain version on {label}: {a}")
            worst[name] = max(worst.get(name, 0.0), a["max_abs_err"])
        _hold_forms(p, label, results, worst)
        _hold_bf16_forms(p, label, results, worst)
    REPORT["kernel_checks"] = results
    return worst


def _zoo_calls(p, plan=None, head_group=None):
    """check name -> (kernel call, plain call, tensors the kernel reads, ops
    by operand type) for the zoo's kernels on one input set: the int8 MLP on
    ``_mlp_plan``'s chunked plan through the public wrapper, the whole int8
    block on ``plan`` (``_block_plan``'s when None), the head-grouped core
    on the head-major permutation of ``p["qkv_b"]``."""
    import torch

    from aiic_tpu_torch.ops import attention, quant

    bsz, seq, width = p["x"].shape
    heads, mlp_dim = p["heads"], p["w1"].shape[-1]
    rows, dim = bsz * seq, width // heads
    core = 4 * bsz * heads * seq * seq * dim
    attn_q = (p["x"], p["ln_s"], p["ln_b"], p["wqkv_q"], p["sqkv"], p["bqkv"], p["wo"], p["bo"],
              p["mask"])
    mlp_q = (p["ln_s"], p["ln_b"], p["w1_q"], p["s1"], p["b1"], p["w2_q"], p["s2"], p["b2"])
    calls = {}
    mode, _, n_chunks = quant._mlp_plan(bsz, seq, width, mlp_dim, 2)
    if mode == "chunked":
        calls["int8_ln_mlp_chunked"] = (
            lambda: quant.int8_ln_mlp(p["x"], *mlp_q),
            lambda: quant.int8_ln_mlp_ref(p["x"], *mlp_q, n_chunks=n_chunks), (p["x"], *mlp_q),
            {"int8": 4 * rows * width * mlp_dim})
    block_plan = plan or quant._block_plan(bsz, seq, width, mlp_dim, 2)
    if block_plan is not None:
        h = dict(heads=heads)
        calls["int8_block"] = (
            lambda: quant.int8_block(*attn_q, *mlp_q, **h, plan_override=plan),
            lambda: quant.int8_block_ref(*attn_q, *mlp_q, **h, plan=block_plan),
            attn_q + mlp_q, {"int8": 2 * rows * width * 3 * width + 4 * rows * width * mlp_dim,
                             "bf16": core + 2 * rows * width * width})
    if head_group is not None:
        if "qkv_hm" not in p:
            perm = torch.from_numpy(attention.headmajor_perm(width, heads)).long()
            p["qkv_hm"] = p["qkv_b"][..., perm.to(p["qkv_b"].device)].contiguous()
        calls["fused_attention_qkv_headgroups"] = (
            lambda: attention.fused_attention_qkv_headgroups(p["qkv_hm"], p["mask"], heads=heads,
                                                             head_group=head_group),
            lambda: attention.fused_attention_qkv_headgroups_ref(p["qkv_hm"], p["mask"], heads),
            (p["qkv_hm"], p["mask"]), {"bf16": core})
    return calls


def _zoo_weights(p):
    """The attention half's and the MLP half's int8 weights of one input set."""
    return ((p["ln_s"], p["ln_b"], p["wqkv_q"], p["sqkv"], p["bqkv"], p["wo"], p["bo"],
             p["mask"]),
            (p["ln_s"], p["ln_b"], p["w1_q"], p["s1"], p["b1"], p["w2_q"], p["s2"], p["b2"]))


def _row34_chunks(p, name: str, plan=None) -> int:
    """The chunk count of row 3 (``_mlp_plan``'s) or of row 4 on ``plan``
    (``_block_plan``'s when None; 1 for a full plan)."""
    from aiic_tpu_torch.ops import quant

    bsz, seq, width = p["x"].shape
    mlp_dim = p["w1"].shape[-1]
    if name == "int8_ln_mlp_chunked":
        return quant._mlp_plan(bsz, seq, width, mlp_dim, 2)[2]
    plan = plan or quant._block_plan(bsz, seq, width, mlp_dim, 2)
    return plan[2] if plan[0] == "chunked" else 1


def _row34_wmma(p, name: str, n_chunks: int):
    """Row 3's or row 4's WMMA form (form 1, uncounted) on one input set."""
    from aiic_tpu_torch.ops import quant

    attn_w, mlp_w = _zoo_weights(p)
    if name == "int8_ln_mlp_chunked":
        return lambda: quant._int8_ln_mlp_cuda(p["x"], *mlp_w, 1e-5, n_chunks, "wmma")
    return lambda: quant._int8_block_cuda(p["x"], attn_w, mlp_w, p["heads"], 1e-5, n_chunks,
                                          "wmma")


def _hold_row34_forms(p, plan, name: str, out, label: str, results: list) -> None:
    """Rows 3 and 4 on the wgmma stage beside their WMMA forms, on ``out``,
    the public wrapper's output: row 3 (``int8_ln_mlp_chunked``) bit for bit
    its form 1; row 4 (``int8_block``) bit for bit row 1's form 0 followed by
    row 2's (full plan) or row 3's (chunked) form 0, and its form 1 bit for
    bit the WMMA rows in turn."""
    import torch

    from aiic_tpu_torch.ops import quant

    attn_w, mlp_w = _zoo_weights(p)
    n_chunks = _row34_chunks(p, name, plan)
    r = {"kernel": name, "case": label, "n_chunks": n_chunks}
    old = _row34_wmma(p, name, n_chunks)()
    if name == "int8_ln_mlp_chunked":
        torch.cuda.synchronize()
        r["form0_bit_identical_to_form1"] = bool(torch.equal(out, old))
    else:
        h = p["heads"]
        y1 = quant._int8_ln_qkv_attention_cuda(p["x"], *attn_w, h, 1e-5)
        rows = quant._int8_ln_mlp_cuda(y1, *mlp_w, 1e-5, n_chunks)
        y1w = quant._int8_ln_qkv_attention_cuda(p["x"], *attn_w, h, 1e-5, "wmma")
        rows_w = quant._int8_ln_mlp_cuda(y1w, *mlp_w, 1e-5, n_chunks, "wmma")
        torch.cuda.synchronize()
        r["form0_bit_identical_to_rows_in_turn"] = bool(torch.equal(out, rows))
        r["form1_bit_identical_to_wmma_rows"] = bool(torch.equal(old, rows_w))
    results.append(r)
    flags = {k: v for k, v in r.items() if "identical" in k}
    log(f"[kernels] {name} {label} (C={n_chunks}) forms: {flags}")
    if not all(flags.values()):
        raise AssertionError(f"{name} on {label}: {r}")


ZOO_KERNEL_CASES = [  # label, inputs, block plan override, head group
    ("L/14 B=1 (MLP C=2)", dict(bsz=1, seq=257, width=1024, heads=16), None, None),
    ("L/14 B=3 (MLP C=2)", dict(bsz=3, seq=257, width=1024, heads=16), None, None),
    ("L/14 B=8 (MLP C=4)", dict(bsz=8, seq=257, width=1024, heads=16), None, None),
    ("L/14 B=2 zero row", dict(bsz=2, seq=257, width=1024, heads=16, zero_row=True), None, None),
    ("L/14 B=3 block (1,16)", dict(bsz=3, seq=257, width=1024, heads=16), ("chunked", 1, 16),
     None),
    ("L/14@336 B=1", dict(bsz=1, seq=577, width=1024, heads=16), None, 8),
    ("L/14@336 B=3", dict(bsz=3, seq=577, width=1024, heads=16), None, 8),
    ("L/14@336 B=8", dict(bsz=8, seq=577, width=1024, heads=16), None, 8),
    ("B/32 B=8", dict(bsz=8, seq=50, width=768, heads=12), None, None),
    ("B/32 B=1", dict(bsz=1, seq=50, width=768, heads=12), None, None),
    ("B/32 B=3", dict(bsz=3, seq=50, width=768, heads=12), None, None),
    ("B/32 B=2 zero row", dict(bsz=2, seq=50, width=768, heads=12, zero_row=True), None, None),
    ("text B=52 causal", dict(bsz=52, seq=77, width=512, heads=8, mask=True), None, None),
    ("L/14 text B=7 causal", dict(bsz=7, seq=77, width=768, heads=12, mask=True), None, None),
    ("B/16 B=8 block (2,4)", dict(bsz=8, seq=197, width=768, heads=12), ("chunked", 2, 4), None),
]


def phase_zoo_kernels(device) -> dict:
    """Phase 3, the zoo's kernels: rows 3, 4 and 8 against their plain
    versions, and row 8 at hg=16 against row 7's kernel on the packed layout
    of the same q, k, v (bit for bit)."""
    import torch

    from aiic_tpu_torch.ops import attention

    rng = np.random.default_rng(20)
    worst, results = {}, []
    for label, kw, plan, hg in ZOO_KERNEL_CASES:
        kw = dict(dict(mask=False, zero_row=False), **kw)
        p = _half_block_inputs(rng, device=device, **kw)
        for name, (kernel, plain, _, _) in _zoo_calls(p, plan, hg).items():
            out = kernel()
            torch.cuda.synchronize()
            if name in ("int8_ln_mlp_chunked", "int8_block"):
                _hold_row34_forms(p, plan, name, out, label, results)
            a = _agreement(out, plain())
            a.update(kernel=name, case=label)
            results.append(a)
            log(f"[kernels] {name:30s} {label:24s} {a['dtype']:8s} max_abs_err={a['max_abs_err']:.6g} "
                f"within_2ulp={a['within_2ulp']:.6f} min_row_cos={a['min_row_cos']:.8f}")
            if not a["ok"]:
                raise AssertionError(f"{name} disagrees with its plain version on {label}: {a}")
            worst[name] = max(worst.get(name, 0.0), a["max_abs_err"])
        if hg is not None:
            heads = kw["heads"]
            all_heads = attention.fused_attention_qkv_headgroups(p["qkv_hm"], heads=heads,
                                                                 head_group=heads)
            row7 = attention._fused_attention_qkv_cuda(p["qkv_b"], None, heads)
            torch.cuda.synchronize()
            same = bool(torch.equal(all_heads, row7))
            log(f"[kernels] fused_attention_qkv_headgroups hg={heads} vs row 7 {label}: "
                f"bit-identical {same}")
            results.append({"kernel": "fused_attention_qkv_headgroups", "case": f"{label} hg=H",
                            "bit_identical_to_row7": same})
            if not same:
                raise AssertionError(f"row 8 at hg={heads} differs from row 7 on {label}")
        del p
    torch.cuda.empty_cache()
    REPORT["zoo_kernel_checks"] = results
    return worst


# The bf16 tensor-core core of rows 7 and 8 (csrc/attn_core_mma.cuh) at its
# tile edges (64 query rows a block, 64-key tiles): B, S, mask kind (False,
# True for causal, "dead_row": causal with rows 0 and S-1 all -inf,
# "clamp": query row 0 scaled by 100 so its scores pass 70 log2 e). Row 7
# runs at W=256, H=4 (at S=577 the copied planner sends the all-heads core
# at W=1024 to the reference composition) and at the L/14 widths where the
# engines run it; row 8 at the L/14@336 width (W=1024, H=16) at hg = 1, 8
# and 16, every group bit for bit the same and hg=16 row 7's kernel.
CORE_EDGE_CASES = ([(b, s, False) for s in (1, 13, 63, 64, 65, 197, 257, 577) for b in (1, 3)]
                   + [(1, 77, True), (3, 77, True), (3, 77, "dead_row"), (2, 577, "dead_row"),
                      (2, 197, "clamp"), (1, 577, "clamp")])
CORE_EDGE_ROW7_WIDTHS = {77: (768, 12), 257: (1024, 16)}  # else (256, 4)


def _core_edge_inputs(gen, bsz, seq, width, kind, device, dtype=None):
    """(B, S, 3W) qkv in ``dtype`` (bf16 by default), the mask and the rows
    the mask removes whole."""
    import torch

    from aiic_tpu_torch.models.clip import causal_mask

    qkv = torch.randn((bsz, seq, 3 * width), generator=gen, device=device)
    if kind == "clamp":
        qkv[:, 0, :width] *= 100.0
    mask, dead = None, []
    if kind in (True, "dead_row"):
        mask = causal_mask(seq, device=device)
    if kind == "dead_row":
        dead = sorted({0, seq - 1})
        mask[dead] = float("-inf")
    return qkv.to(dtype or torch.bfloat16), mask, dead


def _core_edge_agreement(out, ref, dead) -> dict:
    """The bf16 bar on the rows the mask leaves keys in; the rows it removes
    whole exactly zero in kernel and plain version."""
    import torch

    live = [i for i in range(out.shape[1]) if i not in dead]
    a = _agreement(out[:, live], ref[:, live])
    if dead:
        a["dead_rows_zero"] = bool((out[:, dead] == 0).all() and (ref[:, dead] == 0).all())
        a["ok"] = a["ok"] and a["dead_rows_zero"] and bool(torch.isfinite(out.float()).all())
    return a


def mma_core_resources(build_log: str) -> dict:
    """The redesigned kernels' registers, spills and shared memory from the
    build's ``-Xptxas -v`` report: the bf16 core of rows 6-8 and the fp32
    core of rows 6-7 per layout, the two passes of row 9's bf16 and fp32
    backward, row 17's wgmma products and its i8_quant row pass, the GEMM
    stage of rows 1-5 and 10 per epilogue and of rows 11-14 per epilogue
    (the bf16 K-major B of their backward, row 14's folded dh2, the
    tensor-core core backward storing fp32), rows 11-14's tensor-core core
    forward and rank-r kernels per operand type; and their blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; the stage's [int8
    c_fc, bf16 out-projection, folded c_proj, bf16 QKV, bf16 c_fc], the text
    block's ``block_grad.block_occupancy``); rows 15-16's variant core per
    variant and their stage epilogues."""
    from aiic_tpu_torch.ops import attention, block_grad, quant
    from aiic_tpu_torch.probes import mxu_probe

    kernels = {"attn_core_mma_kernel": {"QKVLayoutE0": "packed", "QKVLayoutE1": "head_major",
                                        "QKVLayoutE2": "separate"},
               "core_bwd_mma_query_kernel": {"IfE": "bwd_pass1_f32", "": "bwd_pass1"},
               "core_bwd_mma_key_kernel": {"IfE": "bwd_pass2_f32", "": "bwd_pass2"},
               "attn_core_f32_kernel": {"QKVLayoutE0": "f32_packed", "QKVLayoutE2": "f32_separate"},
               "core_bwd_tiled_query_kernel": {"": "bwd_f32_pass1"},
               "core_bwd_tiled_key_kernel": {"": "bwd_f32_pass2"},
               "mxu_wgmma_kernel": {"ILb0": "mxu_bf16", "ILb1": "mxu_i8"},
               "wgmma_stage_kernel": {"EpiQKV": "stage_qkv", "EpiGelu": "stage_c_fc",
                                      "EpiResidual": "stage_c_proj",
                                      "EpiOutProj": "stage_out_proj",
                                      "EpiChunkResidual": "stage_c_proj_folded",
                                      "EpiBiasQKV": "stage_bf16_qkv",
                                      "EpiBiasGelu": "stage_bf16_c_fc",
                                      "EpiMlpOut": "stage_bf16_c_proj",
                                      # rows 11-14 (mangled names)
                                      "EpiQkvI": "block_bf16_qkv",
                                      "EpiY1I": "block_out_proj",
                                      "EpiFcI": "block_bf16_c_fc",
                                      "EpiYI": "block_bf16_c_proj",
                                      "EpiDfqI": "block_bf16_dfq",
                                      "EpiLoRAOutIS2_fE": "block_bf16_dh",
                                      "EpiLoRAOutIS2_S2_E": "block_da",
                                      "EpiQkv8": "block_int8_qkv",
                                      "EpiFc8": "block_int8_c_fc",
                                      "EpiY8": "block_int8_c_proj",
                                      "EpiDfq8": "block_int8_dfq",
                                      "EpiDh2": "block_int8_dh2",
                                      "NoTail": "stage_chunk_rowscale",
                                      "EpiChunkRowScale": "block_int8_dh2_folded",
                                      "EpiRowScale": "block_int8_dh1",
                                      "EpiSplitStore": "stage_int8_matmul_t",
                                      "EpiF32": "stage_dot_t"},
               "mxu_wgmma_quant_kernel": {"": "mxu_i8_quant"},
               "mxu_quant_rows_kernel": {"": "mxu_i8_quant_row_pass"},
               # rows 11-14's tensor-core core forward and rank-r kernels
               "block_core_fwd_mma_kernel": {"": "block_core_fwd_mma"},
               "rank_down_kernel": {"kernelI13__nv_bfloat16S2_S2_": "rank_down_bf16",
                                    "kernelI13__nv_bfloat16fS2_": "rank_down_bf16_a_f32",
                                    "kernelIfff": "rank_down_f32"},
               "rank_cot_kernel": {"kernelI13__nv_bfloat16S2_S2_": "rank_cot_bf16",
                                   "kernelI13__nv_bfloat16fS2_": "rank_cot_bf16_a_f32",
                                   "kernelIfff": "rank_cot_f32"}}
    # Rows 15-16's form 0: the variants' own stage epilogues (matched before
    # the serving ones whose names they extend) and the variant core per
    # flags, output type and schedule.
    kernels["wgmma_stage_kernel"] = {
        "EpiQKVTile": "variant_stage_qkv_tile", "EpiClip8": "variant_stage_clip8",
        "EpiAddRaw": "variant_stage_add_raw", "EpiResidualStatic": "variant_stage_residual_static",
        "EpiMlp1": "variant_stage_mlp1", "EpiGeluILNS0_4GeluE0": "variant_stage_c_fc_nogelu",
        "EpiGeluILNS0_4GeluE1": "variant_stage_c_fc_sigmoid",
        "EpiGeluILNS0_4GeluE3": "variant_stage_c_fc_bf16", **kernels["wgmma_stage_kernel"]}
    kernels["var_core_mma_kernel"] = {
        "CoreFlagsI" + "".join(f"Lb{b}E" for b in flags) + "EE" + out + f"LNS0_5SchedE{sched}":
        "var_core_" + tag
        for tag, flags, out, sched in (
            ("nomax", "000100", "f", 0), ("v1", "011100", "f", 0), ("v2", "110100", "f", 0),
            ("v3", "111100", "f", 0), ("v4", "010100", "f", 0), ("nosm", "101000", "f", 0),
            ("qobf16", "111100", "13__nv_bfloat16", 0), ("gbatch", "111100", "13__nv_bfloat16", 1),
            ("hstack", "111100", "13__nv_bfloat16", 2), ("hg", "111100", "13__nv_bfloat16", 3),
            ("coreqk", "101110", "13__nv_bfloat16", 0), ("corepv", "101101", "13__nv_bfloat16", 0),
            ("coreboth", "101111", "13__nv_bfloat16", 0))}
    res, lines = {}, build_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        kernel = next((k for k in kernels if k in line), None)
        if kernel is None:
            continue
        tag = next(t for key, t in kernels[kernel].items() if key in line)
        for nxt in lines[i + 1:i + 5]:
            if "spill" in nxt:
                res[tag + "_spills"] = nxt.strip()
            if "Used" in nxt:
                res[tag + "_ptxas"] = nxt.split(":", 1)[-1].strip()
                break
    res["blocks_per_sm"] = attention.mma_core_occupancy()
    res["bwd_blocks_per_sm"] = list(attention.mma_bwd_occupancy())
    res["bwd_f32_blocks_per_sm"] = list(attention.tiled_bwd_occupancy())
    res["f32_blocks_per_sm"] = attention.f32_core_occupancy()
    res["mxu_wgmma_blocks_per_sm"] = mxu_probe.wgmma_occupancy()
    res["stage_blocks_per_sm"] = quant.stage_occupancy()
    res["text_block_blocks_per_sm"] = block_grad.block_occupancy()
    return res


def phase_core_edge_kernels(device, worst: dict) -> None:
    """Phase 3, rows 7 (bf16) and 8 at the tensor-core core's tile edges,
    each launch through its wrapper with the counts at 0 before and one
    launch after; row 8 at hg = 1, 8 and 16 bit for bit the same, and at
    hg=16 bit for bit row 7's kernel on the packed layout. ``worst`` takes
    the largest error of each."""
    import torch

    from aiic_tpu_torch.ops import attention

    gen = torch.Generator(device=device).manual_seed(25)
    results = []
    perm = torch.from_numpy(attention.headmajor_perm(1024, 16)).long().to(device)

    def hold(name, key, label, out, ref, dead, **extra):
        a = _core_edge_agreement(out, ref, dead)
        a.update(kernel=name, case=label, **extra)
        results.append(a)
        log(f"[kernels] {name:30s} {label:26s} max_abs_err={a['max_abs_err']:.6g} "
            f"within_2ulp={a['within_2ulp']:.6f} min_row_cos={a['min_row_cos']:.8f}"
            + "".join(f" {k}={v}" for k, v in extra.items()))
        if not a["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version on {label}: {a}")
        worst[key] = max(worst.get(key, 0.0), a["max_abs_err"])

    for bsz, seq, kind in CORE_EDGE_CASES:
        width, heads = CORE_EDGE_ROW7_WIDTHS.get(seq, (256, 4))
        qkv, mask, dead = _core_edge_inputs(gen, bsz, seq, width, kind, device)
        label = f"B={bsz} S={seq} W={width} {kind}"
        out = _one_launch("fused_attention_qkv",
                          lambda: attention.fused_attention_qkv(qkv, mask, heads=heads))
        hold("fused_attention_qkv", "fused_attention_qkv_bf16", label, out,
             attention.fused_attention_qkv_ref(qkv, mask, heads), dead)
        qkv, mask, dead = _core_edge_inputs(gen, bsz, seq, 1024, kind, device)
        hm = qkv[..., perm].contiguous()
        ref = attention.fused_attention_qkv_headgroups_ref(hm, mask, 16)
        outs = {hg: _one_launch("fused_attention_qkv_headgroups",
                                lambda: attention.fused_attention_qkv_headgroups(
                                    hm, mask, heads=16, head_group=hg))
                for hg in (1, 8, 16)}
        same = all(torch.equal(outs[hg], outs[8]) for hg in (1, 16))
        row7 = bool(torch.equal(outs[16], attention._fused_attention_qkv_cuda(qkv, mask, 16)))
        hold("fused_attention_qkv_headgroups", "fused_attention_qkv_headgroups",
             f"B={bsz} S={seq} W=1024 {kind}", outs[8], ref, dead, hg_bit_identical=same,
             hg16_bit_identical_to_row7=row7)
        if not (same and row7):
            raise AssertionError(f"row 8 on {label}: head groups bit for bit {same}, hg=16 as "
                                 f"row 7 {row7}")
        del qkv, hm, outs, ref
    REPORT["core_edge_checks"] = results


# The bf16 tensor-core forms of rows 9 (the core backward: 64 query rows,
# then 64 key rows a block, K/V or Q/G streamed in 64-row tiles) and 6 (the
# core of rows 7-8 on separate q, k, v) at their tile edges: (B, S, mask
# kind) as CORE_EDGE_CASES; W, H from the S (the text shape at 77, ViT-B/16
# at 197, else W=256, H=4).
BWD_EDGE_CASES = ([(b, s, False) for s in (1, 13, 63, 64, 65, 128, 129, 197, 257) for b in (1, 3)]
                  + [(1, 77, True), (3, 77, True), (3, 77, "dead_row"), (2, 130, "dead_row"),
                     (2, 197, "clamp")])
# fp32 row 9's register-tiled form (64 query rows, then 64 key rows a block,
# the other operand streamed in 64-row tiles, the work cut to the tile's live
# 16-row groups) at its edges: the bf16 ones and a tile of 31, 32 and 33 rows.
BWD_F32_EDGE_CASES = ([(b, s, False) for s in (1, 13, 31, 32, 33, 63, 64, 65, 128, 129, 197, 257)
                       for b in (1, 3)]
                      + [(1, 77, True), (3, 77, True), (3, 77, "dead_row"), (2, 130, "dead_row"),
                         (2, 197, "clamp")])
ROW6_EDGE_CASES = ([(b, s, False) for s in (1, 63, 65, 197) for b in (1, 3)]
                   + [(1, 77, True), (3, 77, True), (3, 77, "dead_row"), (2, 197, "clamp")])
EDGE_WIDTHS = {77: (512, 8), 197: (768, 12)}  # else (256, 4)


def _bwd_edge_agreement(out, ref, dead, width) -> dict:
    """Row 9 in bf16 at the bar per row of the cotangent (the text-block
    kernels' bar: row cosine >= COS_MIN, every element within 2 bf16 ULPs of
    its row's largest |plain| value), in fp32 at the fp32 bar, on the rows
    where the plain cotangent is not all zero; those are all zero in the
    kernel too, and so is dq of a row the mask removes whole. Per element,
    bf16 dq and dk at S=1 are the fp32 rounding noise of ds = p (dp - p dp)
    with p = 1, in kernel and plain version alike, which no 2-ULP share can
    hold; ``within_2ulp`` is kept as a figure."""
    import torch

    zero = (ref == 0).all(dim=-1).all(dim=0)  # (S,): rows all zero in every image
    a = _agreement(out[:, ~zero], ref[:, ~zero], row_scale=True)
    a["zero_rows_zero"] = bool((out[:, zero] == 0).all()) if bool(zero.any()) else None
    a["ok"] = a["ok"] and a["zero_rows_zero"] is not False
    if dead:
        a["dead_rows_dq_zero"] = bool((out[:, dead, :width] == 0).all()
                                      and (ref[:, dead, :width] == 0).all())
        a["ok"] = a["ok"] and a["dead_rows_dq_zero"]
    return a


def phase_core_bwd_edge_kernels(device, worst: dict) -> None:
    """Phase 3, bf16 rows 9 and 6 at the tile edges of their tensor-core
    kernels, and fp32 row 9 at the edges of its register-tiled form, each
    launch through its public wrapper with the counts at 0 before and one
    launch after; bf16 row 9 at S=77 also against its old bf16 one-tile form
    at the bf16 bar. ``worst`` takes the largest error of each."""
    import torch

    from aiic_tpu_torch.ops import attention

    gen = torch.Generator(device=device).manual_seed(26)
    results = []

    def hold(name, label, a, **extra):
        a.update(kernel=name, case=label, **extra)
        results.append(a)
        log(f"[kernels] {name:30s} {label:26s} {a['dtype']:8s} max_abs_err={a['max_abs_err']:.6g} "
            f"max_rel_err={a['max_rel_err']:.3g} within_2ulp={a['within_2ulp']:.6f} "
            f"min_row_cos={a['min_row_cos']:.8f}" + "".join(f" {k}={v}" for k, v in extra.items()))
        if not a["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version on {label}: {a}")
        key = name + ("" if a["dtype"] == "float32" else "_bf16")
        worst[key] = max(worst.get(key, 0.0), a["max_abs_err"])

    for bsz, seq, kind in BWD_EDGE_CASES:
        width, heads = EDGE_WIDTHS.get(seq, (256, 4))
        qkv, mask, dead = _core_edge_inputs(gen, bsz, seq, width, kind, device)
        g = _randn(gen, (bsz, seq, width), torch.bfloat16, device)
        label = f"B={bsz} S={seq} W={width} {kind}"
        out = _one_launch("fused_attention_qkv_bwd",
                          lambda: attention.fused_attention_qkv_bwd(qkv, mask, g, heads=heads))
        a = _bwd_edge_agreement(out, attention.fused_attention_qkv_bwd_ref(qkv, mask, g,
                                                                           heads=heads),
                                dead, width)
        extra = {}
        if seq == 77 and kind is True:
            old = _agreement(out, attention._fused_attention_qkv_bwd_cuda(qkv, mask, g, heads,
                                                                          "one_tile"))
            extra = {"vs_one_tile_within_2ulp": round(old["within_2ulp"], 6),
                     "vs_one_tile_min_row_cos": round(old["min_row_cos"], 8)}
            if not old["ok"]:
                raise AssertionError(f"row 9's tensor-core form disagrees with its one-tile "
                                     f"form on {label}: {old}")
        hold("fused_attention_qkv_bwd", label, a, **extra)
        del qkv, g, out
    for bsz, seq, kind in BWD_F32_EDGE_CASES:
        width, heads = EDGE_WIDTHS.get(seq, (256, 4))
        qkv, mask, dead = _core_edge_inputs(gen, bsz, seq, width, kind, device, torch.float32)
        g = _randn(gen, (bsz, seq, width), torch.float32, device)
        out = _one_launch("fused_attention_qkv_bwd",
                          lambda: attention.fused_attention_qkv_bwd(qkv, mask, g, heads=heads))
        hold("fused_attention_qkv_bwd", f"B={bsz} S={seq} W={width} {kind}",
             _bwd_edge_agreement(out, attention.fused_attention_qkv_bwd_ref(qkv, mask, g,
                                                                            heads=heads),
                                 dead, width))
        del qkv, g, out
    for bsz, seq, kind in ROW6_EDGE_CASES:
        width, heads = EDGE_WIDTHS.get(seq, (256, 4))
        qkv, mask, dead = _core_edge_inputs(gen, bsz, seq, width, kind, device)
        q, k, v = (t.reshape(bsz, seq, heads, 64).contiguous() for t in qkv.split(width, -1))
        out = _one_launch("fused_attention", lambda: attention.flash_attention(q, k, v, mask))
        ref = attention.fused_attention_ref(q, k, v, mask)
        hold("fused_attention", f"B={bsz} S={seq} H={heads} {kind}",
             _core_edge_agreement(out.reshape(bsz, seq, width), ref.reshape(bsz, seq, width),
                                  dead))
        del qkv, q, k, v, out, ref
    torch.cuda.empty_cache()
    REPORT["core_bwd_edge_checks"] = results


# fp32 rows 7 and 6 (D=64) on the register-tiled core (csrc/attn_core_f32.cuh:
# 64 query rows a block, K and V streamed in 64-key tiles, each product cut
# to the tile pair's live 16-row groups) at its edges, which are fp32 row 9's
# (the same tiles and groups); W, H from EDGE_WIDTHS. Row 6 also at S=577
# (B=2, H=16), where the scalar core it replaced refused.
FWD_F32_EDGE_CASES = BWD_F32_EDGE_CASES
ROW6_F32_WIDE = (2, 577, 16)  # B, S, H


def phase_core_f32_edge_kernels(device, worst: dict) -> None:
    """Phase 3, fp32 rows 7 and 6 at the register-tiled core's tile edges,
    each launch through its public wrapper with the counts at 0 before and
    one launch after, at the fp32 bar on the rows the mask leaves keys in
    (rows it removes whole exactly zero); row 6 bit for bit row 7 on the
    same q, k, v (one kernel body), a second row 7 launch bit for bit the
    first; the scalar core the tiled one replaced (``form="scalar"``,
    uncounted) held too where K and V fit its shared memory. ``worst``
    takes the largest error of each."""
    import torch

    from aiic_tpu_torch.ops import attention

    gen = torch.Generator(device=device).manual_seed(27)
    results = []

    def hold(name, label, out, ref, dead, key=None, **extra):
        a = _core_edge_agreement(out, ref, dead)
        a.update(kernel=name, case=label, **extra)
        results.append(a)
        log(f"[kernels] {name:30s} {label:26s} {a['dtype']:8s} max_abs_err={a['max_abs_err']:.6g} "
            f"max_rel_err={a['max_rel_err']:.3g}" + "".join(f" {k}={v}" for k, v in extra.items()))
        if not (a["ok"] and all(v is not False for v in extra.values())):
            raise AssertionError(f"{name} on {label}: {a}")
        key = key or name
        worst[key] = max(worst.get(key, 0.0), a["max_abs_err"])

    for bsz, seq, kind in FWD_F32_EDGE_CASES:
        width, heads = EDGE_WIDTHS.get(seq, (256, 4))
        qkv, mask, dead = _core_edge_inputs(gen, bsz, seq, width, kind, device, torch.float32)
        label = f"B={bsz} S={seq} W={width} {kind}"
        ref = attention.fused_attention_qkv_ref(qkv, mask, heads)
        out = _one_launch("fused_attention_qkv",
                          lambda: attention.fused_attention_qkv(qkv, mask, heads=heads))
        hold("fused_attention_qkv", label, out, ref, dead, repeats_bit_for_bit=bool(
            torch.equal(attention._fused_attention_qkv_cuda(qkv, mask, heads), out)))
        q, k, v = (t.reshape(bsz, seq, heads, 64).contiguous() for t in qkv.split(width, -1))
        out6 = _one_launch("fused_attention",
                           lambda: attention.flash_attention(q, k, v, mask)).reshape(bsz, seq, width)
        hold("fused_attention", label, out6, ref, dead,
             row7_bit_identical=bool(torch.equal(out6, out)))
        if 2 * seq * 64 * 4 <= attention._MAX_SMEM:
            hold("fused_attention_qkv", label + " scalar form",
                 attention._fused_attention_qkv_cuda(qkv, mask, heads, "scalar"), ref, dead,
                 key="fused_attention_qkv_scalar")
        del qkv, q, k, v, out, out6, ref
    bsz, seq, heads = ROW6_F32_WIDE
    q, k, v = (_randn(gen, (bsz, seq, heads, 64), torch.float32, device) for _ in range(3))
    out = _one_launch("fused_attention", lambda: attention.flash_attention(q, k, v))
    hold("fused_attention", f"B={bsz} S={seq} H={heads}", out.reshape(bsz, seq, -1),
         attention.fused_attention_ref(q, k, v).reshape(bsz, seq, -1), [])
    del q, k, v, out
    torch.cuda.empty_cache()
    REPORT["core_f32_edge_checks"] = results


# Row 6: label, (B, S, H, D, causal); row 9: label, (B, S, H, causal).
ROW6_CASES = [("ViT-B/16 B=2", (2, 197, 12, 64, False)), ("ViT-B/16 B=256", (256, 197, 12, 64, False)),
              ("text B=7 causal", (7, 77, 8, 64, True)), ("D=8 B=2 causal", (2, 16, 4, 8, True))]
ROW9_CASES = ([(f"S=77 causal B={b}", (b, 77, 8, True)) for b in (1, 7, 64, 256)]
              + [(f"S=197 B={b}", (b, 197, 12, False)) for b in (1, 7, 64, 256)])
PROBE_CHECK_INNER = 3  # the probe kernels against their plain versions at a small INNER


def _randn(gen, shape, dtype, device):
    import torch

    return torch.randn(shape, generator=gen, device=device).to(dtype)


# The GEMM stage launches inside each launch of rows 1-3 (their two products
# each) and row 4 (four); the stage's own count says so.
STAGE_LAUNCHES = {"int8_ln_qkv_attention": 2, "int8_ln_mlp": 2, "int8_ln_mlp_chunked": 2,
                  "int8_block": 4}
# Rows 5 and 10 (bf16) launch the stage twice each too, but count one launch
# of their own and none of the stage's; so do rows 11-14 in bf16 and int8
# (form 0): four products a forward (QKV, the out-projection, c_fc,
# c_proj), seven a backward (the recomputed forward's first three, then
# dy.W2^T, dfq.W1^T, dy1.Wo^T, dqkv.Wqkv^T). fp32 rows 11-12 launch none: no
# trace of them goes through _device_ms_by_kernel.
BF16_STAGE_LAUNCHES = {"fused_ln_qkv_attention": 2, "fused_ln_mlp": 2,
                       "text_block_fwd": 4, "text_block_bwd": 7,
                       "text_block_fwd_int8": 4, "text_block_bwd_int8": 7}
# The kernel-experiment variants' form 0 likewise: each of the 25 runs two
# products on the stage (QKV or c_fc, then the out-projection or c_proj).
VARIANT_STAGE_LAUNCHES = 2
BF16_STAGE_LAUNCHES.update({w: VARIANT_STAGE_LAUNCHES for w in (
    "int8_attn_nomax", "mlp_var", "attn_var2", "mlp_var3", "attn_var4", "attn_var5",
    "attn_var7")})


def _one_launch(name: str, fn):
    """fn() with every launch count set to 0 before; afterwards exactly one
    launch of ``name`` (and the GEMM stage's launches inside it, for rows
    1-4) and none of any other kernel."""
    import torch

    from aiic_tpu_torch.ops._build import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got = launch_counts()
    want = {n: int(n == name) for n in got}
    want["gemm_stage"] += STAGE_LAUNCHES.get(name, 0)
    if got != want:
        raise AssertionError(f"expected one launch of {name} alone, got "
                             f"{ {n: c for n, c in got.items() if c} }")
    return out


def _row9_inputs(gen, bsz, seq, heads, causal, dtype, device):
    from aiic_tpu_torch.models.clip import causal_mask

    w = 64 * heads
    return (_randn(gen, (bsz, seq, 3 * w), dtype, device), _randn(gen, (bsz, seq, w), dtype, device),
            causal_mask(seq, device=device) if causal else None)


def phase_core_ops_kernels(device) -> dict:
    """Phase 3, rows 6, 9 and 17 against their plain versions, each call
    through the public wrapper with the counts at 0 before and one launch
    after. Row 9 runs its register-tiled form in fp32 and its tensor-core
    form in bf16, at every S; fp32's scalar forms that the tiled one
    replaced are held too: the one-tile kernel at S=77 (the text-block
    backward's core, common.cuh's block_core_bwd_kernel) and the two-pass
    streaming form, which must repeat the one-tile kernel bit for bit. Row
    6 in bf16 runs the tensor-core core at every S. Row 17's bodies run
    their wgmma form, beside the WMMA form it replaced on the same inputs;
    the int8 body must be exact in both, at a small INNER and at the INNER
    that ``mxu_probe.run`` launches."""
    import torch

    from aiic_tpu_torch.models.clip import causal_mask
    from aiic_tpu_torch.ops import attention
    from aiic_tpu_torch.probes import mxu_probe

    gen = torch.Generator(device=device).manual_seed(30)
    worst, results = {}, []

    def record(name, label, out, ref, key=None, **extra):
        a = _agreement(out, ref)
        a.update(kernel=name, case=label, **extra)
        results.append(a)
        log(f"[kernels] {name:24s} {label:20s} {a['dtype']:8s} max_abs_err={a['max_abs_err']:.6g} "
            f"max_rel_err={a['max_rel_err']:.3g} within_2ulp={a['within_2ulp']:.6f} "
            f"min_row_cos={a['min_row_cos']:.8f}"
            + "".join(f" {k}={v}" for k, v in extra.items()))
        if not a["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version on {label}: {a}")
        key = key or name + ("" if out.dtype == torch.float32 else "_bf16")
        worst[key] = max(worst.get(key, 0.0), a["max_abs_err"])

    for dtype in (torch.float32, torch.bfloat16):
        for label, (bsz, seq, heads, dim, causal) in ROW6_CASES:
            q, k, v = (_randn(gen, (bsz, seq, heads, dim), dtype, device) for _ in range(3))
            mask = causal_mask(seq, device=device) if causal else None
            out = _one_launch("fused_attention", lambda: attention.flash_attention(q, k, v, mask))
            record("fused_attention", label, out, attention.fused_attention_ref(q, k, v, mask))
            del q, k, v, out
        for label, (bsz, seq, heads, causal) in ROW9_CASES:
            qkv, g, mask = _row9_inputs(gen, bsz, seq, heads, causal, dtype, device)
            out = _one_launch("fused_attention_qkv_bwd", lambda: attention.fused_attention_qkv_bwd(
                qkv, mask, g, heads=heads))
            ref = attention.fused_attention_qkv_bwd_ref(qkv, mask, g, heads=heads)
            record("fused_attention_qkv_bwd", label, out, ref)
            if dtype == torch.bfloat16:
                continue
            # fp32's scalar forms, which the register-tiled one replaced: each
            # against the plain version, and the streaming form bit for bit
            # the one-tile kernel where both apply.
            streamed = attention._fused_attention_qkv_bwd_cuda(qkv, mask, g, heads, "streaming")
            extra = {}
            if seq <= attention._BWD_TILE_ROWS:
                one_tile = attention._fused_attention_qkv_bwd_cuda(qkv, mask, g, heads, "one_tile")
                extra["streaming_bit_identical"] = bool(torch.equal(streamed, one_tile))
                if not extra["streaming_bit_identical"]:
                    raise AssertionError(f"row 9's streaming form differs from its one-tile "
                                         f"kernel on {label} {dtype}")
                record("fused_attention_qkv_bwd", label + " one-tile form", one_tile, ref,
                       key="fused_attention_qkv_bwd_one_tile")
            record("fused_attention_qkv_bwd", label + " streaming form", streamed, ref,
                   key="fused_attention_qkv_bwd_streaming", **extra)
    x_bf, x_i8, w_bf, w_i8 = mxu_probe.inputs(device)
    for inner in (PROBE_CHECK_INNER, mxu_probe.INNER):
        for name, (x, w) in (("mxu_bf16", (x_bf, w_bf)), ("mxu_i8", (x_i8, w_i8)),
                             ("mxu_i8_quant", (x_bf, w_i8))):
            out = _one_launch(name, lambda: getattr(mxu_probe, name)(x, w, inner))
            ref = getattr(mxu_probe, name + "_ref")(x, w, inner)
            # The WMMA form the wgmma one replaced (uncounted), on the same inputs.
            old = mxu_probe._probe_cuda(name, x, w, inner, "wmma")
            for form, o in (("wgmma", out), ("wmma", old)):
                exact = bool(torch.equal(o, ref))
                if name == "mxu_i8" and not exact:
                    raise AssertionError(f"the int8 probe's {form} form is not exact at "
                                         f"INNER={inner}")
                record(name, f"rows={x.shape[0]} INNER={inner} {form}", o, ref,
                       key=name if form == "wgmma" else name + "_wmma", bit_identical=exact)
            del out, old, ref
    torch.cuda.empty_cache()
    REPORT["core_ops_kernel_checks"] = results
    return worst


# ---------------------------------------------------------------------------
# Phases 4-5: the slice, and the CPU comparison
# ---------------------------------------------------------------------------


def _pixels(rng, n, size):
    return rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _engine(params, device, opts, config, **kw):
    import torch

    from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer

    opts = dict(opts, dtype=getattr(torch, opts["dtype"]))
    return InteriorAnalyzer(params, config, training_data=TRAINING_DATA, device=device,
                            **opts, **kw)


def _large_s_core(seq: int, width: int, heads: int) -> list:
    """The core of the large-S attention half (int8 or bf16): the packed
    core where it fits, else the head-grouped one, else none (plain)."""
    from aiic_tpu_torch.ops import attention as A

    if A.qkv_core_fits(seq, width, 2):
        return ["fused_attention_qkv"]
    return (["fused_attention_qkv_headgroups"]
            if A.pick_head_group(seq, heads, width // heads, 2) is not None else [])


def _block_kernels(opts: dict, seq: int, width: int, heads: int, bsz: int) -> list:
    """The kernels one block of ``models.clip.block`` launches in this
    configuration at this geometry and batch, derived from the copied JAX
    planners in the JAX package's branch order (tests/test_torch_zoo.py
    pins the planners and the branches to JAX's)."""
    from aiic_tpu_torch.ops import attention as A
    from aiic_tpu_torch.ops import quant as Q

    mlp_dim = 4 * width
    if opts["dtype"] == "float32":  # plain projections around the packed core, if it fits
        return (["fused_attention_qkv"]
                if A.fits_some_group(bsz, 4, lambda g: A.qkv_core_fits(seq, width, 4, g)) else [])
    if opts["quantize"]:
        plan = Q._block_plan(bsz, seq, width, mlp_dim, 2)
        if plan is not None and plan[0] == "full" and plan[1] >= 2:  # the auto rule
            return ["int8_block"] + ["gemm_stage"] * STAGE_LAUNCHES["int8_block"]
        # Rows 1-3 launch the GEMM stage twice each, the large-S int8
        # projection once.
        if A.fits_some_group(bsz, 2, lambda g: Q._attn_vmem_bytes(g, seq, width, 2)
                             <= Q._VMEM_BUDGET):
            names = ["int8_ln_qkv_attention", "gemm_stage", "gemm_stage"]
        else:
            core = _large_s_core(seq, width, heads)
            names = core + ["gemm_stage"] if core else []
        mode = Q._mlp_plan(bsz, seq, width, mlp_dim, 2)[0]
        return names + {"full": ["int8_ln_mlp", "gemm_stage", "gemm_stage"],
                        "chunked": ["int8_ln_mlp_chunked", "gemm_stage", "gemm_stage"],
                        "xla": []}[mode]
    if A.fits_some_group(bsz, 2, lambda g: A.ln_attn_vmem_bytes(g, seq, width, 2)
                         <= A._CORE_VMEM_BUDGET):
        names = ["fused_ln_qkv_attention"]
    else:
        names = _large_s_core(seq, width, heads)
    return names + (["fused_ln_mlp"] if opts["attn_impl"] == "pallas_mlp" else [])


def _expected_launches(opts: dict, config, n_prompts: int, buckets) -> tuple:
    """(launches at build, launches in all) of every kernel: the text tower
    once at build over all prompts, then the image tower once per request
    chunk at its bucket (the last image block is the CLS-row block, no
    kernel)."""
    build: dict = {}
    t, v = config.text, config.vision
    for name in _block_kernels(opts, config.context_length, t.width, t.heads, n_prompts):
        build[name] = build.get(name, 0) + t.layers
    total = dict(build)
    for b in buckets:
        for name in _block_kernels(opts, config.vision_seq_len, v.width, v.heads, b):
            total[name] = total.get(name, 0) + v.layers - 1
    return build, total


def phase_path(label: str, params, device, requests, tag: str = "", paths=PATHS,
               **engine_kw):
    """One path: every count set to 0, the engine built (text features
    through the text tower) and asked three requests; then every kernel's
    launches must be exactly what ``_expected_launches`` derives for the
    text batch at build and each request's bucket, and 0 for the others.
    ``engine_kw`` (``use_lora`` ...) go to the engine of ``paths[label]``,
    reported as ``label + tag``."""
    import torch

    from aiic_tpu_torch.models import config as configs
    from aiic_tpu_torch.ops._build import launch_counts, reset_launch_counts
    from aiic_tpu_torch.utils.batching import bucket_size

    conf, preset = paths[label]
    opts, config = CONFIGS[conf], getattr(configs, preset)
    reset_launch_counts()
    t0 = time.perf_counter()
    engine = _engine(params, device, opts, config, **engine_kw)
    label = label + tag
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    at_build = launch_counts()
    # the 7-image request unfiltered, so the attribute branch runs too
    t0 = time.perf_counter()
    answers = [engine.analyze_pixels(px, filter_interiors=len(px) != 7) for px in requests]
    torch.cuda.synchronize()
    answer_s = time.perf_counter() - t0
    launches = launch_counts()

    n_prompts = engine.det_text.shape[0] + int(engine.cat_mask.sum())
    buckets = [bucket_size(len(px[i:i + engine.max_batch]), engine.max_batch)
               for px in requests for i in range(0, len(px), engine.max_batch)]
    want_build, want = _expected_launches(opts, config, n_prompts, buckets)
    log(f"[path {label}] {config.name} {opts}: engine built in {build_s:.3f} s, requests "
        f"answered in {answer_s:.3f} s; launches at build {at_build}, after requests "
        f"{launches} (expected {want_build} and {want} for {n_prompts} prompts and buckets "
        f"{buckets}, 0 for the others)")
    for name in launches:
        if at_build[name] != want_build.get(name, 0) or launches[name] != want.get(name, 0):
            raise AssertionError(f"path {label}: {name} launched {at_build[name]} times at build "
                                 f"and {launches[name]} in all, expected "
                                 f"{want_build.get(name, 0)} and {want.get(name, 0)}")
    for px, res in zip(requests, answers):
        if len(res) != len(px):
            raise AssertionError(f"{len(res)} answers for {len(px)} images")
        for r in res:
            if set(r) != {"is_interior", "interior_confidence", "detected_category",
                          "analysis", "reason"} or not np.isfinite(r["interior_confidence"]):
                raise AssertionError(f"malformed answer {r}")
    raw = engine.classify_pixels(requests[2])
    for k, v in raw.items():
        if v.dtype.kind == "f" and not np.isfinite(v).all():
            raise AssertionError(f"non-finite {k}")
    if raw["features"].shape != (len(requests[2]), config.embed_dim):
        raise AssertionError(f"features shape {raw['features'].shape}")
    if not all(r["is_interior"] and len(r["analysis"]) == len(engine.category_names)
               for r in answers[1]):
        raise AssertionError("an unfiltered answer lacks its attribute analysis")
    verdicts = [r["is_interior"] for res in answers[::2] for r in res]
    log(f"[path {label}] answered {[len(px) for px in requests]} images; {sum(verdicts)} of "
        f"{len(verdicts)} filtered ones judged interior; all outputs finite")
    REPORT.setdefault("paths", {})[label] = {
        "preset": config.name, "options": opts, "build_s": build_s, "answer_s": answer_s,
        "launches_at_build": at_build, "launches": launches, "expected_at_build": want_build,
        "expected": want, "buckets": buckets, "prompts": n_prompts}
    return engine, {name: n for name, n in launches.items() if n}


def phase_slice(device):
    """Phase 4: the four paths from one seeded init."""
    import torch

    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.models.init import init_clip_params

    gen = torch.Generator(device=device).manual_seed(0)
    params = init_clip_params(VIT_B_16, gen, device=device)
    rng = np.random.default_rng(1)
    requests = [_pixels(rng, n, VIT_B_16.image_size) for n in (1, 7, 64)]
    engines, launches = {}, {}
    for label in PATHS:
        engine, counts = phase_path(label, params, device, requests)
        _add(launches, counts)
        if label in ("int8", "bf16", "bf16_pallas_mlp"):  # timed below
            engines[label] = engine
    paths = REPORT["paths"]
    same = all(paths["int8_auto"][k] == paths["int8"][k] for k in ("launches_at_build", "launches"))
    log(f"[path int8_auto] launches equal to the int8 (pallas) engine's: {same}")
    if not same:
        raise AssertionError(f"attn_impl='auto' launched {paths['int8_auto']['launches']}, the "
                             f"int8 engine {paths['int8']['launches']}")
    return engines, params, launches


def _add(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def phase_cpu_compare(label: str, engine, params, tag: str = "", paths=PATHS, n_images=4,
                      **engine_kw) -> None:
    """Phase 5: the same weights and pixels through the engine's plain
    versions on the CPU."""
    import torch

    from aiic_tpu_torch.models.init import tree_map

    cpu_params = tree_map(lambda t: t.cpu(), params)
    t0 = time.perf_counter()
    cpu = _engine(cpu_params, "cpu", CONFIGS[paths[label][0]], engine.config, **engine_kw)
    label = label + tag
    px = _pixels(np.random.default_rng(2), n_images, engine.config.image_size)
    a = engine.classify_pixels(px)
    b = cpu.classify_pixels(px)
    fa, fb = a["features"], b["features"]
    cos = (fa * fb).sum(-1) / (np.linalg.norm(fa, axis=-1) * np.linalg.norm(fb, axis=-1))
    text_cos = float(torch.nn.functional.cosine_similarity(
        engine.det_text.float().cpu(), cpu.det_text.float(), dim=-1).min())
    verdict = lambda r: (r["interior_mass"] > r["non_interior_mass"]) & (r["top_conf"] > 0.3)  # noqa: E731
    same_verdict = bool((verdict(a) == verdict(b)).all())
    same_top1 = bool((a["top_idx"] == b["top_idx"]).all())
    log(f"[cpu {label}] plain CPU path vs card on {n_images} images "
        f"({time.perf_counter() - t0:.1f} s): "
        f"min feature cosine {cos.min():.6f}, min detector-text cosine {text_cos:.6f}, "
        f"verdicts equal {same_verdict}, top-1 equal {same_top1}; "
        f"top_conf card {np.round(a['top_conf'], 5).tolist()} cpu {np.round(b['top_conf'], 5).tolist()}")
    res = {"min_feature_cos": float(cos.min()), "min_text_cos": text_cos,
           "same_verdict": same_verdict, "same_top1": same_top1}
    REPORT.setdefault("cpu_compare", {})[label] = res
    if min(cos.min(), text_cos) < 0.999 or not same_verdict or not same_top1:
        raise AssertionError(f"card and CPU disagree on the {label} path: {res}")


def _rank4_checkpoint(path: str) -> None:
    """A seeded rank-4 c_fc/c_proj text adapter with nonzero B, in the
    reference ``.pth`` layout (the shape of the reference's shipped ones)."""
    import torch

    from aiic_tpu_torch.adapters import save_lora_pth
    from aiic_tpu_torch.models.config import VIT_B_16

    t = VIT_B_16.text
    rng = np.random.default_rng(13)
    def f(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.02).astype(np.float32))

    save_lora_pth({"c_fc": {"A": f(t.layers, t.width, 4), "B": f(t.layers, 4, t.mlp_dim)},
                   "c_proj": {"A": f(t.layers, t.mlp_dim, 4), "B": f(t.layers, 4, t.width)}},
                  path)


def phase_lora_engines(params, device, base, root: str) -> None:
    """Int8 ``use_lora`` engines from the ``int8_text`` adapters of phase 7
    (rank 16, alpha 32; the analyzer folds only c_fc and c_proj, so the
    checkpoint's out_proj factors are skipped, as in the JAX engine) and from
    a rank-4 checkpoint with the analyzer's default rank and alpha: each
    answers 1, 7 and 64 images with exact launch counts, its text features
    differ from those of ``base`` (the same backbone without the adapter),
    and it agrees with its CPU run."""
    from aiic_tpu_torch.models.config import VIT_B_16

    rng = np.random.default_rng(12)
    requests = [_pixels(rng, n, VIT_B_16.image_size) for n in (1, 7, 64)]
    rank4 = os.path.join(root, "rank4.pth")
    _rank4_checkpoint(rank4)
    cases = {
        "_lora_int8_text": dict(lora_weights_path=os.path.join(root, "int8_text", "adapters.pth"),
                                lora_rank=16, lora_alpha=32),
        "_lora_rank4": dict(lora_weights_path=rank4),
    }
    for tag, kw in cases.items():
        engine, _ = phase_path("int8", params, device, requests, tag=tag, use_lora=True, **kw)
        moved = float((engine.det_text - base.det_text).abs().max())
        log(f"[path int8{tag}] max |text feature change| from the adapter: {moved:.6g}")
        REPORT["paths"]["int8" + tag]["text_feature_change"] = moved
        if not moved > 0:
            raise AssertionError(f"use_lora {tag}: the adapter left the text features unchanged")
        phase_cpu_compare("int8", engine, params, tag=tag, use_lora=True, **kw)
        del engine


def _zoo_cosine(label: str, engine, params) -> None:
    """The twin of tools/zoo_cosine.py: the int8 engine's image features
    against the bf16 reference composition (``attn_impl="xla"``, no
    kernels, unquantized weights) on the card, at full depth."""
    import torch

    from aiic_tpu_torch.models.clip import encode_image, normalize_features
    from aiic_tpu_torch.ops.preprocess import normalize_u8

    config = engine.config
    px = _pixels(np.random.default_rng(22), 2, config.image_size)
    feats = engine.classify_pixels(px)["features"]
    with torch.inference_mode():
        x = normalize_u8(torch.from_numpy(px).to(engine.device), dtype=torch.bfloat16)
        base = normalize_features(encode_image(params, x, config, dtype=torch.bfloat16,
                                               attn_impl="xla")).cpu().numpy()
    cos = (feats * base).sum(-1)
    log(f"[zoo-cosine {label}] {config.name} int8 engine vs bf16 xla on the card, 2 images: "
        f"cosine {np.round(cos, 6).tolist()}")
    REPORT.setdefault("zoo_cosine", {})[label] = cos.tolist()
    if cos.min() < ZOO_COS_MIN:
        raise AssertionError(f"{label}: int8 features {cos.min():.6f} from the bf16 xla path")


def phase_zoo(device):
    """Phase 10: the zoo's paths, each with exact launch counts, against its
    CPU run, and (int8) against the bf16 xla path; returns the int8 engines
    (timed below) and the launches of all paths."""
    import torch

    from aiic_tpu_torch.models import config as configs
    from aiic_tpu_torch.models.init import init_clip_params

    engines, launches, params, preset_of = {}, {}, None, None
    for label, (conf, preset) in ZOO_PATHS.items():
        config = getattr(configs, preset)
        if preset != preset_of:
            params, preset_of = None, preset
            torch.cuda.empty_cache()
            params = init_clip_params(config, torch.Generator(device=device).manual_seed(0),
                                      device=device)
        rng = np.random.default_rng(21)
        requests = [_pixels(rng, n, config.image_size) for n in (1, 7, 64)]
        engine, counts = phase_path(label, params, device, requests, paths=ZOO_PATHS)
        _add(launches, counts)
        phase_cpu_compare(label, engine, params, paths=ZOO_PATHS, n_images=2)
        if conf == "int8":
            _zoo_cosine(label, engine, params)
            engines[label] = engine
        del engine
    torch.cuda.empty_cache()
    return engines, launches


# Rows 3 and 4 timed at B=256 (and row 4 at the text tower's 52 prompts):
# times key, label, inputs, the wrapper.
ZOO_TIMED = [
    ("int8_ln_mlp_chunked", "B=256 S=257 W=1024 (L/14, C=4)",
     dict(bsz=256, seq=257, width=1024, heads=16), "int8_ln_mlp_chunked"),
    ("int8_ln_mlp_chunked_l14_336", "B=256 S=577 W=1024 (L/14@336, C=4)",
     dict(bsz=256, seq=577, width=1024, heads=16), "int8_ln_mlp_chunked"),
    ("int8_block", "B=256 S=50 W=768 (B/32, full)", dict(bsz=256, seq=50, width=768, heads=12),
     "int8_block"),
    ("int8_block_text", "B=52 S=77 W=512 causal (text, full)",
     dict(bsz=52, seq=77, width=512, heads=8, mask=True), "int8_block"),
]
# Device time of rows 1-4 by stage: kernel-name needles of both forms (the
# folded c_proj also alone).
ZOO_STAGE_NEEDLES = {"row_pass": "rowquant_kernel", "wgmma_stage": "wgmma_stage_kernel",
                     "wmma_gemm": "gemm_kernel<", "core_mma": "attn_core_mma_kernel",
                     "core_scalar": "attn_core_kernel<", "folded_c_proj": "EpiChunkResidual",
                     "chunk_sum": "mlp_chunk_sum_kernel"}


def _chunk_products(p, n_chunks: int) -> dict:
    """Row 3's two products for ``gemm_stage`` (``_stage_products``' tuples):
    c_fc, and c_proj with the chunk sums folded in on yq and its (rows, C)
    scales, made by the plain pieces (LN row quantizer, c_fc with gelu, y
    quantized per (row, chunk))."""
    from aiic_tpu_torch.ops import attention, quant

    x = p["x"]
    bsz, seq, width = x.shape
    rows, mlp_dim = bsz * seq, p["w1"].shape[-1]
    h = attention._ln_fp32(x.float().reshape(rows, width), p["ln_s"].reshape(1, width),
                           p["ln_b"].reshape(1, width), 1e-5)
    hq, hs = quant._row_quant(h)
    fc_kw = dict(row_scale=hs, col_scale=p["s1"], bias=p["b1"])
    y = quant.gemm_stage_ref(hq, p["w1_q"], "gelu", **fc_kw)
    yq, ys = quant._row_quant(y.reshape(rows * n_chunks, mlp_dim // n_chunks))
    del h, y
    ops = {"int8": 2 * rows * mlp_dim * width}
    return {"gemm_stage_c_fc": (hq, p["w1_q"], "gelu", fc_kw, ops),
            "gemm_stage_c_proj_folded": (
                yq.reshape(rows, mlp_dim), p["w2_q"], "chunk_residual",
                dict(row_scale=ys.reshape(rows, n_chunks), col_scale=p["s2"], bias=p["b2"],
                     x=x.reshape(rows, width), n_chunks=n_chunks), ops)}


def _row34_times(t: dict, p, key: str, name: str, card: str, worst: dict) -> None:
    """Beside row 3's or row 4's new form (timed by the caller): the stage
    yardstick (``torch._int_mm`` per int8 product, ``torch.matmul`` for
    the bf16 out-projection, no epilogue: the median of 5 each) and, for
    row 3, the folded c_proj alone (``gemm_stage``, held against its plain
    version) beside ``torch._int_mm`` on the same operands."""
    t["n_chunks"] = _row34_chunks(p, name)
    if name == "int8_ln_mlp_chunked":
        products = _chunk_products(p, t["n_chunks"])
        fold = "gemm_stage_c_proj_folded"
        stage: dict = {}
        _kernel_times(_stage_calls({fold: products[fold]}), stage, f"{key} (folded c_proj)",
                      card, hold={fold: "gemm_stage"}, worst=worst)
        f = t["folded_c_proj"] = stage[fold]
        f["yardstick_ms"] = _library_ms(_stage_library(products[fold]))["library_ms"]
        log(f"[timing] {fold:24s} {key}: folded c_proj alone {f['ms']:.3f} ms, torch._int_mm "
            f"on the same operands {f['yardstick_ms']:.3f} ms ({card})")
    else:
        products = _stage_products(p)
    t["stage_yardstick_ms"] = sum(_library_ms(_stage_library(prod))["library_ms"]
                                  for prod in products.values())
    del products
    log(f"[timing] {key:24s} stage yardstick {t['stage_yardstick_ms']:.3f} ms ({card})")


def _peak_mb(fn) -> float:
    """Device memory fn() takes at its peak beyond what was allocated before,
    in MB (``torch.cuda.max_memory_allocated``)."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - before) / 1e6


def _row34_forms(t: dict, p, key: str, label: str, name: str, card: str) -> None:
    """Row 3's or row 4's two forms on the inputs its new form was timed on
    (by the caller, ``_kernel_times``): the WMMA form timed the same way
    (the best of two 10-call runs), both forms' device ms by stage
    (``_device_ms_by_kernel``; c_fc apart) and peak memory; form 0 on the
    wgmma stage with no WMMA GEMM, scalar core or chunk-sum pass, and held
    to its form 1 (``_hold_row34_forms``)."""
    new, wmma = _zoo_calls(p)[name][0], _row34_wmma(p, name, t["n_chunks"])
    t["wmma_ms"] = min(_time_ms(wmma, 10) for _ in range(2))
    needles = {**ZOO_STAGE_NEEDLES, "c_fc": "EpiGelu"}
    for tag, fn in (("", new), ("wmma_", wmma)):
        t[tag + "device_ms_by_stage"] = _device_ms_by_kernel(fn, needles)
        t[tag + "peak_mb"] = _peak_mb(fn)
    log(f"[timing] {key:24s} new form {t['ms']:.3f} ms, device ms by stage "
        f"{t['device_ms_by_stage']}, peak {t['peak_mb']:.1f} MB; WMMA form {t['wmma_ms']:.3f} ms, "
        f"{t['wmma_device_ms_by_stage']}, peak {t['wmma_peak_mb']:.1f} MB ({card})")
    d = t["device_ms_by_stage"]
    if d["wgmma_stage"] is None or any(d[k] is not None
                                       for k in ("wmma_gemm", "core_scalar", "chunk_sum")):
        raise AssertionError(f"{key}: the new form launched {d}")
    _hold_row34_forms(p, None, name, new(), label, REPORT.setdefault("zoo_timed_form_checks", []))


def _engine_kernels(label: str, engine, rng) -> None:
    """One 8-image classify call of an int8 zoo engine launches the wgmma
    stage and no WMMA gemm_kernel or chunk-sum pass (rows 1-4 on the
    stage)."""
    px = _pixels(rng, 8, engine.config.image_size)
    d = _device_ms_by_kernel(lambda: engine.classify_pixels(px), ZOO_STAGE_NEEDLES)
    REPORT.setdefault("zoo_engine_kernels_per_chunk", {})[label] = d
    log(f"[path {label}] one 8-image classify call, device ms by kernel kind: {d}")
    if d["wgmma_stage"] is None or d["wmma_gemm"] is not None or d["chunk_sum"] is not None:
        raise AssertionError(f"the {label} engine's image chunk launched {d}")


def phase_zoo_timing(device, card: str, engines, worst: dict) -> dict:
    """Phase 10's timings: rows 3 and 4 at ``ZOO_TIMED``'s shapes (plain,
    kernel, kernel, plain; held against their plain versions with one
    counted launch each) beside the stage yardstick and, for row 3, the
    folded c_proj alone (``_row34_times``); their WMMA forms timed the same
    way, both forms' device ms by stage and peak memory, form 0 held to its
    form 1 (``_row34_forms``);
    row 8 at ViT-L/14@336 B=256 (hg=8) beside scaled_dot_product_attention
    on the same q, k, v, held against its plain version there (``worst``
    takes the errors); each int8 zoo engine's chunk on the stage
    (``_engine_kernels``), its images/s at B=256 and single-image p50.
    Launch counts are put back."""
    import torch

    from aiic_tpu_torch.ops import _build, attention

    saved = _build.launch_counts()
    times = {}
    rng = np.random.default_rng(23)
    for key, label, kw, name in ZOO_TIMED:
        p = _half_block_inputs(rng, **dict(dict(mask=False, zero_row=False), **kw), device=device)
        _kernel_times({key: _zoo_calls(p)[name]}, times, label, card, hold={key: name},
                      worst=worst)
        _row34_times(times[key], p, key, name, card, worst)
        _row34_forms(times[key], p, key, label, name, card)
        del p
        torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(23)
    qkv_hm = torch.randn((256, 577, 3072), generator=gen, device=device).to(torch.bfloat16)
    calls = {"fused_attention_qkv_headgroups": (
        lambda: attention.fused_attention_qkv_headgroups(qkv_hm, heads=16, head_group=8),
        lambda: attention.fused_attention_qkv_headgroups_ref(qkv_hm, None, 16), (qkv_hm,),
        {"bf16": 4 * 256 * 16 * 577 * 577 * 64})}
    _kernel_times(calls, times, "B=256 S=577 W=1024 hg=8 (L/14@336)", card, worst=worst,
                  hold={"fused_attention_qkv_headgroups": "fused_attention_qkv_headgroups"})
    times["fused_attention_qkv_headgroups"].update(_sdpa_times(qkv_hm, 16, head_major=True))
    log(f"[timing] fused_attention_qkv_headgroups SDPA "
        f"{times['fused_attention_qkv_headgroups']['library_ms']:.3f} ms, transposes "
        f"{times['fused_attention_qkv_headgroups']['transpose_ms']:.3f} ms ({card})")
    del calls, qkv_hm
    torch.cuda.empty_cache()
    for fn in _build._COUNTED.values():
        fn.launches = saved[fn.__name__]
    rng = np.random.default_rng(24)
    for label, engine in engines.items():
        _engine_kernels(label, engine, rng)
        times[f"classify_{label}"] = r = _engine_rate(engine, rng)
        log(f"[timing] classify_pixels {label} B=256: {r['images_per_s_b256']:.1f} images/s; "
            f"single image p50 {r['single_image_p50_ms']:.3f} ms ({card})")
    REPORT.setdefault("timing", {}).update(times)
    return times


# ---------------------------------------------------------------------------
# Phases 6-8: training
# ---------------------------------------------------------------------------

# The training paths of phase 7: TrainConfig options, the resolved text path.
TRAIN_PATHS = {
    "fp32_auto": (dict(dtype="float32", attn_impl="auto"), "pallas_vjp"),
    "fp32_block_fused": (dict(dtype="float32", attn_impl="block_fused"), "block_fused"),
    "bf16_block_fused": (dict(dtype="bfloat16", attn_impl="block_fused"), "block_fused"),
    # train_lora --attn-impl block_fused --quantize-text --quantize-image
    "int8_text": (dict(dtype="float32", attn_impl="block_fused", quantize_text=True,
                       quantize_image=True), "block_fused_int8"),
}
TRAIN_ITEMS, TRAIN_BATCH, TRAIN_EPOCHS = 56, 16, 2
STYLES = ["nowoczesny", "klasyczny", "skandynawski", "industrialny"]
ROOMS = ["kuchnia", "salon", "sypialnia", ""]
CHARS = ["czyste linie", "przestronne", "eleganckie", "jasne"]
# The LoRA cotangents are fp32 sums over all B*S rows: in fp32 a kernel
# agrees when max |kernel - plain| <= LORA_F32_REL * max |plain| per factor;
# in bf16 when the factor's cosine to the plain one is at least COS_MIN.
LORA_F32_REL = 1e-5


def _text_block_inputs(rng, bsz, dtype, device, rank=16, w=512):
    """The B/16 text block (S=77, W=512, M=2048, H=8; or another width w,
    M = 4w) with rank-16 LoRA on all three attach points, B nonzero; x and an
    output cotangent."""
    import torch

    from aiic_tpu_torch.models.clip import causal_mask

    m = 4 * w

    def t(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(device)

    bp = {"ln1": {"scale": 1 + t(w, std=0.1), "bias": t(w, std=0.1)},
          "ln2": {"scale": 1 + t(w, std=0.1), "bias": t(w, std=0.1)},
          "attn": {"wqkv": t(w, 3 * w, std=w ** -0.5), "bqkv": t(3 * w, std=0.1),
                   "wo": t(w, w, std=w ** -0.5), "bo": t(w, std=0.1)},
          "mlp": {"w1": t(w, m, std=w ** -0.5), "b1": t(m, std=0.1),
                  "w2": t(m, w, std=m ** -0.5), "b2": t(w, std=0.1)}}
    dims = {"out_proj": (w, w), "c_fc": (w, m), "c_proj": (m, w)}
    lora = {p: {"A": t(dims[p][0], rank, std=0.02), "B": t(rank, dims[p][1], std=0.02)}
            for p in dims}
    return {"x": t(bsz, 77, w).to(dtype), "dy": t(bsz, 77, w, std=0.01).to(dtype),
            "mask": causal_mask(77, device=device), "bp": bp, "lora": lora, "heads": w // 64}


def _quantized(bp):
    """The per-output-channel int8 weights of one block, as
    ``quantize_model_mlp`` makes them: {wqkv_q, sqkv, w1_q, s1, w2_q, s2}."""
    from aiic_tpu_torch.ops.quant import quantize_weight

    qw = {}
    for key, scale, (grp, name) in (("wqkv_q", "sqkv", ("attn", "wqkv")),
                                    ("w1_q", "s1", ("mlp", "w1")), ("w2_q", "s2", ("mlp", "w2"))):
        qw[key], qw[scale] = quantize_weight(bp[grp][name])
    return qw


def _tree_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_tensors(v)]
    return [tree]


def _block_calls(p):
    """name -> (kernel call, plain call, tensors the kernel reads, ops by
    type). The operations are what the function does on these inputs. The
    forward: the backbone products 2 rows W (4W + 2M), the core 4 B H S^2 D,
    the rank-r products 2 rows (r_o 2W + r_f (W + M) + r_p (M + W)). The
    backward recomputes the forward without its last product (y itself is
    not needed): 2 rows W (4W + M), the core, the rank-r products less u_ap
    Bp; then the four input-gradient products 2 rows W (4W + 2M), the core's
    8 B H S^2 D, and the rank-r cotangent and gradient products 2 rows
    (4 r_o W + 2 r_f (W + M) + 2 r_p (W + M)). (The TPU cost estimate,
    block_grad.py:958-964, counts three full forwards: 381.3 GFLOP at B=256
    against the 216.0 + rank-r counted here.)"""
    from aiic_tpu_torch.ops import block_grad

    x, dy, mask, bp, lora = p["x"], p["dy"], p["mask"], p["bp"], p["lora"]
    ops = _block_ops(p)
    fwd, bwd = (sum(o.values()) for o in ops)
    kind = "fp32" if x.dtype.itemsize == 4 else "bf16"
    kw = dict(heads=p["heads"], scaling=2.0)
    weights = _tree_tensors(bp) + _tree_tensors(lora)
    return {
        "text_block_fwd": (
            lambda: block_grad.text_block_fwd(x, mask, bp, lora, **kw),
            lambda: block_grad.text_block_fwd_ref(x, mask, bp, lora, **kw),
            [x, mask, *weights], {kind: fwd}),
        "text_block_bwd": (
            lambda: block_grad.text_block_bwd(x, dy, mask, bp, lora, **kw),
            lambda: block_grad.text_block_bwd_ref(x, dy, mask, bp, lora, **kw),
            [x, dy, mask, *weights], {kind: bwd}),
    }


def _block_ops(p):
    """(forward, backward) operations of one text block by product:
    {"wide": the backbone products (QKV, c_fc, c_proj), "wo": the output
    projection, "rest": the core and the rank-r products}."""
    x, bp, lora = p["x"], p["bp"], p["lora"]
    bsz, seq, w = x.shape
    rows, heads, m = bsz * seq, p["heads"], bp["mlp"]["w1"].shape[-1]
    r_o, r_f, r_p = (lora[k]["A"].shape[-1] for k in ("out_proj", "c_fc", "c_proj"))
    core = 4 * bsz * heads * seq * seq * (w // heads)
    fwd_rank = 2 * rows * (r_o * 2 * w + r_f * (w + m) + r_p * (m + w))
    fwd = {"wide": 2 * rows * w * (3 * w + 2 * m), "wo": 2 * rows * w * w,
           "rest": core + fwd_rank}
    bwd = {"wide": 2 * rows * w * (3 * w + m) + 2 * rows * w * (3 * w + 2 * m),
           "wo": 2 * 2 * rows * w * w,
           "rest": (core + fwd_rank - 2 * rows * r_p * w + 2 * core
                    + 2 * rows * (4 * r_o * w + 2 * r_f * (w + m) + 2 * r_p * (w + m)))}
    return fwd, bwd


def _int8_block_calls(p):
    """As ``_block_calls`` for the int8 pair on the weights of ``p``,
    quantized per output channel: the wide products count at the int8 peak,
    wo, the core and the rank-r products at the bf16 one. The plain version
    takes the plan's chunk count, which the wrappers resolve themselves."""
    from aiic_tpu_torch.ops import block_grad

    x, dy, mask, bp, lora = p["x"], p["dy"], p["mask"], p["bp"], p["lora"]
    qw = p["qw"]
    bsz, seq, width = x.shape
    n_chunks = block_grad.text_block_int8_plan(seq, width, 4 * width, p["heads"], bsz=bsz)[1]
    kw = dict(heads=p["heads"], scaling=2.0)
    ops = [{"int8": o["wide"], "bf16": o["wo"] + o["rest"]} for o in _block_ops(p)]
    weights = _tree_tensors(bp) + _tree_tensors(lora) + list(qw.values())
    return {
        "text_block_fwd_int8": (
            lambda: block_grad.text_block_fwd_int8(x, mask, bp, qw, lora, **kw),
            lambda: block_grad.text_block_fwd_int8_ref(x, mask, bp, qw, lora, n_chunks=n_chunks,
                                                       **kw),
            [x, mask, *weights], ops[0]),
        "text_block_bwd_int8": (
            lambda: block_grad.text_block_bwd_int8(x, dy, mask, bp, qw, lora, **kw),
            lambda: block_grad.text_block_bwd_int8_ref(x, dy, mask, bp, qw, lora,
                                                       n_chunks=n_chunks, **kw),
            [x, dy, mask, *weights], ops[1]),
    }


def _lora_agreement(got: dict, ref: dict, fp32: bool) -> dict:
    import torch

    worst = {}
    for pt in ref:
        for ab in "AB":
            g, r = got[pt][ab], ref[pt][ab]
            worst[f"{pt}.{ab}"] = (
                float((g - r).abs().max() / r.abs().max()) if fp32 else
                float(torch.nn.functional.cosine_similarity(g.flatten(), r.flatten(), dim=0)))
    ok = (all(v <= LORA_F32_REL for v in worst.values()) if fp32
          else all(v >= COS_MIN for v in worst.values()))
    return {"per_factor": worst, "ok": ok}


def _block_check(name: str, label: str, out, ref, dl, dl_ref, kind: str, int8: bool) -> dict:
    """One text-block output against a reference at the text-block bars
    (y and bf16 dx per row within 2 bf16 ULPs of the row's largest value and
    row cosine >= COS_MIN; int8 dx the row cosine alone; the LoRA
    cotangents as ``_lora_agreement``), logged; raises where it fails."""
    import torch

    a = _agreement(out, ref, row_scale=True)
    a.update(kernel=name, case=label, against=kind)
    if dl is not None:
        a["lora"] = _lora_agreement(dl, dl_ref, out.dtype == torch.float32)
        ok = a["finite"] and a["min_row_cos"] >= COS_MIN if int8 else a["ok"]
        a["ok"] = ok and a["lora"]["ok"]
    log(f"[kernels] {name:24s} {label:24s} {kind:14s} {a['dtype']:8s} "
        f"max_abs_err={a['max_abs_err']:.6g} max_rel_err={a['max_rel_err']:.3g} "
        f"within_2ulp={a['within_2ulp']:.6f} "
        f"max_err_in_row_max_ulps={a['max_err_in_row_max_ulps']:.3g} "
        f"min_row_cos={a['min_row_cos']:.8f}"
        + (f" lora={a['lora']['per_factor']}" if "lora" in a else ""))
    if not a["ok"]:
        raise AssertionError(f"{name} ({kind}) disagrees on {label}: {a}")
    return a


# The kernels a form-0 call of rows 11-14 must launch (the wgmma stage, the
# tensor-core core forward, the rank-r down-projections; in the backward row
# 9's two tensor-core passes and the rank-r cotangent products) and those of
# the first design it must not (common.cuh's WMMA gemm_kernel,
# block_core_bwd_kernel, block_core_fwd_kernel, the 64x16 SIMT tile of the
# rank-r products). fp32 rows 11-12 (one route): the SIMT tile, the rank-r
# kernels, the register-tiled cores of rows 6-7 and 9.
BLOCK_FORM0_KERNELS = ("wgmma_stage_kernel", "block_core_fwd_mma_kernel", "rank_down_kernel")
BLOCK_FORM0_BWD_KERNELS = ("core_bwd_mma_query_kernel", "core_bwd_mma_key_kernel",
                           "rank_cot_kernel")
BLOCK_FORM1_KERNELS = ("::gemm_kernel<", "block_core_bwd_kernel", "block_core_fwd_kernel<",
                       "simt_gemm_kernel<")
BLOCK_F32_KERNELS = ("sgemm_kernel", "rank_down_kernel", "attn_core_f32_kernel")
BLOCK_F32_BWD_KERNELS = ("core_bwd_tiled_query_kernel", "core_bwd_tiled_key_kernel",
                         "rank_cot_kernel")


def _block_form0_kernels(fn, backward: bool, fp32: bool = False) -> list:
    """The CUDA kernels that fn() (a form-0 text-block call) launches, from
    ``_trace``; a trace that misses a kernel it must show is taken again
    (the profiler drops leading records), up to PROFILE_TRIES. Raises
    unless every kernel of ``BLOCK_FORM0_KERNELS`` (and, in the backward,
    ``BLOCK_FORM0_BWD_KERNELS``; fp32: ``BLOCK_F32_KERNELS`` and
    ``BLOCK_F32_BWD_KERNELS``) is there and none of
    ``BLOCK_FORM1_KERNELS``."""
    if fp32:
        want = BLOCK_F32_KERNELS + (BLOCK_F32_BWD_KERNELS if backward else ())
    else:
        want = BLOCK_FORM0_KERNELS + (BLOCK_FORM0_BWD_KERNELS if backward else ())
    for _ in range(PROFILE_TRIES):
        names = sorted({ev.key for ev in _trace(fn)})
        missing = [w for w in want if not any(w in n for n in names)]
        if not missing:
            break
    stale = [n for n in names if any(k in n for k in BLOCK_FORM1_KERNELS)]
    if missing or stale:
        raise AssertionError(f"a form-0 text-block call launched {names}: missing {missing}, "
                             f"first-design kernels {stale}")
    return names


def _rank_shapes(rows: int, width: int, rank: int = 16) -> list:
    """Every rank-r product of rows 11-14 at ``rows`` text rows and text
    width W (M = 4W): (label, kind, a shape, b shape, trans, a in fp32 in the
    bf16 block). Down-projections a.Ao, h2.Af (depth W), u.Ap (M; u fp32 in
    the int8 block), dy.Bp^T (W), dfq.Bf^T (M; fp32 in int8), dy1.Bo^T (W,
    dy1 fp32); the six cotangents over the rows, P = W or M, three stored
    transposed."""
    m = 4 * width
    return [("a.Ao", "down", (rows, width), (width, rank), False, False),
            ("u.Ap", "down", (rows, m), (m, rank), False, True),
            ("dy.Bp^T", "down", (rows, width), (rank, width), True, False),
            ("dfq.Bf^T", "down", (rows, m), (rank, m), True, True),
            ("dy1.Bo^T", "down", (rows, width), (rank, width), True, True),
            ("u^T t_p", "cotangent", (rows, m), (rows, rank), False, True),
            ("dy^T u_ap", "cotangent", (rows, width), (rows, rank), True, False),
            ("h2^T t_f", "cotangent", (rows, width), (rows, rank), False, False),
            ("dfq^T h2_af", "cotangent", (rows, m), (rows, rank), True, True),
            ("dy1^T a_ao", "cotangent", (rows, width), (rows, rank), True, True)]


def _hold_rank_products(device, rows: int, width: int, label: str, fp32: bool) -> dict:
    """The rank-r kernels of form 0 (and fp32's route) bit for bit form 1's
    narrow_gemm at every launch shape of ``_rank_shapes`` (in bf16 with a
    in bf16 and, where the block passes an fp32 activation, in fp32);
    raises where one differs."""
    import torch

    from aiic_tpu_torch.ops import block_grad

    gen = torch.Generator(device=device).manual_seed(rows + width)
    dtype = torch.float32 if fp32 else torch.bfloat16
    held = {}
    for name, kind, a_shape, b_shape, trans, a_f32 in _rank_shapes(rows, width):
        for a_fp32 in ((True,) if fp32 else ((False, True) if a_f32 else (False,))):
            a = torch.randn(a_shape, generator=gen, device=device)
            a = a if a_fp32 else a.to(dtype)
            b = torch.randn(b_shape, generator=gen, device=device).to(dtype)
            kw = dict(trans=trans, scaling=2.0)
            got = block_grad.rank_product_cuda(a, b, kind, **kw)
            if not torch.equal(got, block_grad.rank_product_cuda(a, b, kind, form="wmma", **kw)):
                raise AssertionError(f"rank-r product {name} ({label}, a {a.dtype}) is not "
                                     f"narrow_gemm bit for bit")
            held[f"{name} a={str(a.dtype)[6:]}"] = list(a_shape)
    log(f"[kernels] rank-r products {label} {str(dtype)[6:]}: rank_down_kernel / rank_cot_kernel "
        f"bit for bit narrow_gemm at {len(held)} launch shapes {held}")
    return held


def _hold_core_forward(p, label: str, results: list) -> None:
    """Form 0's tensor-core core forward (``block_core_fwd_mma_kernel``, p
    normalized before p.V) against form 1's ``block_core_fwd_kernel`` and
    the plain version on the same qkv at the bf16 bar (``_agreement``), and
    bit for bit its own second run."""
    import torch

    from aiic_tpu_torch.ops import block_grad

    x, mask, h = p["x"], p["mask"], p["heads"]
    gen = torch.Generator(device=x.device).manual_seed(x.shape[0])
    qkv = torch.randn((x.shape[0], 77, 3 * x.shape[-1]), generator=gen,
                      device=x.device).to(torch.bfloat16)
    a0 = block_grad.block_core_fwd_cuda(qkv, mask, h)
    for kind, ref in (("vs_block_core_fwd_kernel",
                       block_grad.block_core_fwd_cuda(qkv, mask, h, form="wmma")),
                      ("vs_plain", block_grad.block_core_fwd_ref(qkv, mask, h))):
        a = _agreement(a0, ref)
        a.update(kernel="block_core_fwd_mma", case=label, against=kind)
        results.append(a)
        log(f"[kernels] block_core_fwd_mma {label:24s} {kind:24s} max_abs_err="
            f"{a['max_abs_err']:.6g} within_2ulp={a['within_2ulp']:.6f} "
            f"min_row_cos={a['min_row_cos']:.8f}")
        if not a["ok"]:
            raise AssertionError(f"the tensor-core core forward disagrees ({kind}) on {label}: {a}")
    if not torch.equal(a0, block_grad.block_core_fwd_cuda(qkv, mask, h)):
        raise AssertionError(f"the tensor-core core forward does not repeat on {label}")


def _hold_block_forms(p, label: str, results: list, int8: bool, form0, ref) -> None:
    """Rows 11-14 beside their first design (form 1, uncounted) on the
    inputs of ``p``: form 1 against the plain version and form 0 against
    form 1 at the text-block bars, form 0 a second time bit for bit the
    first, and form 0's kernels (``_block_form0_kernels``). The int8
    forward's two forms are not bit for bit: their int32 products are, but
    form 0's core forward sums fp32 on the tensor cores in another order;
    ``_hold_core_forward`` holds that core alone against form 1's."""
    import torch

    from aiic_tpu_torch.ops import block_grad

    x, dy, mask, bp, lora, h = p["x"], p["dy"], p["mask"], p["bp"], p["lora"], p["heads"]
    a = (h, 2.0, 1e-5)
    if int8:
        qw = p["qw"]
        c = block_grad._int8_chunks(x, 4 * x.shape[-1], h, None)
        fwd = lambda form: block_grad._text_block_fwd_int8_cuda(  # noqa: E731
            x, mask, bp, qw, lora, *a, form)
        bwd = lambda form: block_grad._text_block_bwd_int8_cuda(  # noqa: E731
            x, dy, mask, bp, qw, lora, *a, c, form)
        names = ("text_block_fwd_int8", "text_block_bwd_int8")
    else:
        fwd = lambda form: block_grad._text_block_fwd_cuda(x, mask, bp, lora, *a, form)  # noqa: E731
        bwd = lambda form: block_grad._text_block_bwd_cuda(  # noqa: E731
            x, dy, mask, bp, lora, *a, form)
        names = ("text_block_fwd", "text_block_bwd")
    y0, (dx0, dl0) = form0
    y_ref, (dx_ref, dl_ref) = ref
    y1, (dx1, dl1) = fwd("wmma"), bwd("wmma")
    torch.cuda.synchronize()
    for kind, y, yr, dx, dxr, dl, dlr in (
            ("wmma_vs_plain", y1, y_ref, dx1, dx_ref, dl1, dl_ref),
            ("wgmma_vs_wmma", y0, y1, dx0, dx1, dl0, dl1)):
        results.append(_block_check(names[0], label, y, yr, None, None, kind, int8))
        results.append(_block_check(names[1], label, dx, dxr, dl, dlr, kind, int8))
    y2, (dx2, dl2) = fwd("wgmma"), bwd("wgmma")
    torch.cuda.synchronize()
    same = torch.equal(y0, y2) and torch.equal(dx0, dx2) and all(
        torch.equal(dl0[q][ab], dl2[q][ab]) for q in dl0 for ab in "AB")
    if not same:
        raise AssertionError(f"{names} form 0: a second run on {label} is not the first bit for bit")
    launched = {"fwd": _block_form0_kernels(lambda: fwd("wgmma"), False),
                "bwd": _block_form0_kernels(lambda: bwd("wgmma"), True)}
    REPORT.setdefault("text_block_form0_kernels", {})[f"{names[1]} {label}"] = launched
    log(f"[kernels] {names[0]}/{names[1]} {label}: form 0 repeats bit for bit; launches the wgmma "
        f"stage, block_core_fwd_mma_kernel and rank_down_kernel (and core_bwd_mma_* and "
        f"rank_cot_kernel in the backward), no WMMA gemm_kernel, block_core_bwd_kernel, "
        f"block_core_fwd_kernel or simt_gemm_kernel")


def phase_text_block_kernels(device) -> dict:
    """Phase 6: the text-block kernels against their plain versions; bf16
    and int8 (rows 11-14) in form 0 beside form 1 (``_hold_block_forms``),
    with the tensor-core core forward alone (``_hold_core_forward``); fp32
    rows 11-12's kernels from a trace; at every case the rank-r kernels bit
    for bit narrow_gemm at the block's launch shapes
    (``_hold_rank_products``)."""
    import torch

    from aiic_tpu_torch.ops import block_grad

    rng = np.random.default_rng(5)
    worst, results = {}, []
    REPORT["rank_product_bits"] = rank_bits = {}
    for dtype in (torch.float32, torch.bfloat16):
        for bsz in (1, 7, 64):
            p = _text_block_inputs(rng, bsz, dtype, device)
            calls = _block_calls(p)
            y = calls["text_block_fwd"][0]()
            dx, dl = calls["text_block_bwd"][0]()
            torch.cuda.synchronize()
            y_ref = calls["text_block_fwd"][1]()
            dx_ref, dl_ref = calls["text_block_bwd"][1]()
            label = f"B={bsz} S=77 W=512"
            results.append(_block_check("text_block_fwd", label, y, y_ref, None, None, "plain",
                                        False))
            results.append(_block_check("text_block_bwd", label, dx, dx_ref, dl, dl_ref, "plain",
                                        False))
            # the line's entries are the fp32 (CLI default) kernels, bf16 beside
            suffix = "" if dtype == torch.float32 else "_bf16"
            for name, a in zip(("text_block_fwd", "text_block_bwd"), results[-2:]):
                worst[name + suffix] = max(worst.get(name + suffix, 0.0), a["max_abs_err"])
            rank_bits[f"{label} {str(dtype)[6:]}"] = _hold_rank_products(
                device, bsz * 77, 512, label, dtype == torch.float32)
            if dtype == torch.bfloat16:
                _hold_core_forward(p, label, results)
                _hold_block_forms(p, label, results, False, (y, (dx, dl)),
                                  (y_ref, (dx_ref, dl_ref)))
            else:
                a = (p["heads"], 2.0, 1e-5)
                args = (p["x"], p["mask"], p["bp"], p["lora"])
                REPORT.setdefault("text_block_form0_kernels", {})[f"fp32 {label}"] = {
                    "fwd": _block_form0_kernels(
                        lambda: block_grad._text_block_fwd_cuda(*args, *a), False, True),
                    "bwd": _block_form0_kernels(
                        lambda: block_grad._text_block_bwd_cuda(args[0], p["dy"], *args[1:], *a),
                        True, True)}
    cases = [(f"B={bsz} S=77 W=512", dict(bsz=bsz)) for bsz in (1, 7, 64)]
    cases.append(("B=7 S=77 W=768 chunked", dict(bsz=7, w=768)))
    for label, kw in cases:
        p = _text_block_inputs(rng, dtype=torch.bfloat16, device=device, **kw)
        p["qw"] = _quantized(p["bp"])
        calls = _int8_block_calls(p)
        y = calls["text_block_fwd_int8"][0]()
        dx, dl = calls["text_block_bwd_int8"][0]()
        torch.cuda.synchronize()
        y_ref = calls["text_block_fwd_int8"][1]()
        dx_ref, dl_ref = calls["text_block_bwd_int8"][1]()
        for name, out, ref, g, g_ref in (("text_block_fwd_int8", y, y_ref, None, None),
                                         ("text_block_bwd_int8", dx, dx_ref, dl, dl_ref)):
            a = _block_check(name, label, out, ref, g, g_ref, "plain", True)
            results.append(a)
            worst[name] = max(worst.get(name, 0.0), a["max_abs_err"])
        _hold_core_forward(p, label, results)
        if "W=768" in label:
            rank_bits[label] = _hold_rank_products(device, 7 * 77, 768, label, False)
        _hold_block_forms(p, label, results, True, (y, (dx, dl)), (y_ref, (dx_ref, dl_ref)))
    REPORT["text_block_checks"] = results
    return worst


def _synth_dataset(root: str, n: int, size: int = 256):
    """n random size x size PNGs and a dataset JSON with items built like
    TRAINING_DATA (style, room type, characteristics, materials, colours)."""
    from PIL import Image

    rng = np.random.default_rng(7)
    items = []
    for i in range(n):
        name = f"img{i:03d}.png"
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            os.path.join(root, name))
        items.append({"image_path": name, "style": STYLES[i % 4],
                      "characteristics": CHARS[: i % 3], "materials": ["drewno"],
                      "colors": ["biały"], "room_type": ROOMS[(i // 4) % 4]})
    path = os.path.join(root, "dataset.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"training_data": items}, f, ensure_ascii=False)
    return path


def _train_config(opts, **kw):
    import torch

    from aiic_tpu_torch.train import TrainConfig

    return TrainConfig(**dict(opts, dtype=getattr(torch, opts["dtype"])), **kw)


def _path_params(params, opts):
    """The backbone as ``train_lora`` hands it to the step: with
    ``quantize_text``, the text tower's int8 weights attached."""
    from aiic_tpu_torch.ops.quant import quantize_model_mlp

    return (quantize_model_mlp(params, attn=True, towers=("text",))
            if opts.get("quantize_text") else params)


def _expected_train_launches(opts: dict, text_impl: str, n_items: int) -> dict:
    """Launches of one train_lora run, derived from the design:

    - the image-feature precompute runs the frozen tower once per chunk of
      TRAIN_BATCH unique images (the last padded): 11 launches per chunk of
      the packed core (fp32), of the bf16 attention half-block, or (with
      ``quantize_image``) of each int8 half-block and four of the GEMM stage
      inside them (the last image block is the CLS-row block, no kernel);
    - pallas_vjp (remat on): the packed core 12 times per text encode, and
      12 more per train step where the backward recomputes each block: 24
      per train step, 12 per eval step;
    - block_fused: ``text_block_fwd`` 12 per train and per eval step,
      ``text_block_bwd`` 12 per train step (no remat: the backward kernel
      recomputes its forward itself); block_fused_int8 the same of
      ``text_block_fwd_int8`` and ``text_block_bwd_int8``."""
    n_val = max(1, int(n_items * 0.1))
    train_steps = TRAIN_EPOCHS * ((n_items - n_val) // TRAIN_BATCH)
    eval_steps = TRAIN_EPOCHS * max(1, n_val // TRAIN_BATCH)
    chunks = -(-n_items // TRAIN_BATCH)
    if opts.get("quantize_image"):
        image = ("int8_ln_qkv_attention", "int8_ln_mlp")
    else:
        image = ("fused_attention_qkv" if opts["dtype"] == "float32" else "fused_ln_qkv_attention",)
    want = {name: 11 * chunks for name in image}
    if opts.get("quantize_image"):
        want["gemm_stage"] = 11 * chunks * sum(STAGE_LAUNCHES[name] for name in image)
    if text_impl == "pallas_vjp":
        want["fused_attention_qkv"] = want.get("fused_attention_qkv", 0) + 24 * train_steps \
            + 12 * eval_steps
    else:
        suffix = "_int8" if text_impl == "block_fused_int8" else ""
        want["text_block_fwd" + suffix] = 12 * (train_steps + eval_steps)
        want["text_block_bwd" + suffix] = 12 * train_steps
    return want


def phase_train(params, device, root: str) -> dict:
    """Phase 7: train_lora on each path from the serving phases' seeded
    init, with exact launch counts; the adapters go under ``root``."""
    import torch

    from aiic_tpu_torch.adapters import parse_lora_key
    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.ops._build import launch_counts, reset_launch_counts
    from aiic_tpu_torch.train import train_lora

    launches, rates = {}, {}
    t0 = time.perf_counter()
    json_path = _synth_dataset(root, TRAIN_ITEMS)
    log(f"[train] synthetic dataset of {TRAIN_ITEMS} 256x256 PNGs written in "
        f"{time.perf_counter() - t0:.2f} s")
    for label, (opts, text_impl) in TRAIN_PATHS.items():
        save = os.path.join(root, label, "adapters.pth")
        cfg = _train_config(opts, epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH, seed=0)
        reset_launch_counts()
        t0 = time.perf_counter()
        out = train_lora(json_path, save, params=params, config=VIT_B_16, cfg=cfg,
                         log=lambda msg, label=label: log(f"[train {label}] {msg}"),
                         device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = launch_counts()
        want = _expected_train_launches(opts, text_impl, TRAIN_ITEMS)
        log(f"[train {label}] {opts}: {seconds:.2f} s; launches {got} (expected {want}, "
            f"0 for the others)")
        for name, n in got.items():
            if n != want.get(name, 0):
                raise AssertionError(f"train {label}: {name} launched {n} times, "
                                     f"expected {want.get(name, 0)}")
        hist = out["history"]
        if not all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"]) for h in hist):
            raise AssertionError(f"train {label}: non-finite loss {hist}")
        moved = max(float(out["lora_tree"][p]["B"].abs().max()) for p in out["lora_tree"])
        if not moved > 0:
            raise AssertionError(f"train {label}: adapter B did not move off zero")
        sd = torch.load(save, map_location="cpu", weights_only=True)
        if (len(sd) != 6 * VIT_B_16.text.layers
                or not all(parse_lora_key(k) and k.startswith("clip_model.") for k in sd)
                or not all(v.dtype == torch.float32 for v in sd.values())):
            raise AssertionError(f"train {label}: .pth keys {sorted(sd)[:3]}...")
        last = hist[-1]
        rates[label] = last["train_images"] / last["train_seconds"]
        log(f"[train {label}] losses {[(h['train_loss'], h['val_loss']) for h in hist]}; "
            f"max |B| {moved:.3g}; .pth has {len(sd)} reference keys; epoch "
            f"{last['epoch']}: {last['train_images']} images in "
            f"{last['train_seconds']:.3f} s = {rates[label]:.1f} images/s")
        REPORT.setdefault("train", {})[label] = {
            "options": opts, "text_impl": text_impl, "seconds": seconds, "history": hist,
            "launches": got, "expected": want, "epoch_images_per_s": rates[label]}
        for name in ("text_block_fwd", "text_block_bwd", "text_block_fwd_int8",
                     "text_block_bwd_int8"):
            launches[name] = launches.get(name, 0) + got[name]
    return launches, rates


def _step_batch(rng, rows: int, device):
    """Cached-feature rows and dense token rows of distinct prompts."""
    import torch

    from aiic_tpu_torch.data.tokenizer import tokenize_for_model
    from aiic_tpu_torch.models.config import VIT_B_16

    feats = rng.standard_normal((rows, VIT_B_16.embed_dim)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    prompts = [f"{CHARS[i % 4]} {STYLES[(i // 4) % 4]} wnętrze {ROOMS[(i // 16) % 4]} {i}"
               for i in range(rows)]
    tokens = tokenize_for_model(prompts, VIT_B_16)
    return torch.from_numpy(feats).to(device), torch.from_numpy(tokens).to(device)


def _lora_init(rng, device):
    import torch

    from aiic_tpu_torch.models.config import VIT_B_16

    t = VIT_B_16.text
    dims = {"out_proj": (t.width, t.width), "c_fc": (t.width, t.mlp_dim),
            "c_proj": (t.mlp_dim, t.width)}
    return {p: {ab: torch.from_numpy((rng.standard_normal(
        (t.layers, *((dims[p][0], 16) if ab == "A" else (16, dims[p][1])))) * 0.02)
        .astype(np.float32)).to(device) for ab in "AB"} for p in dims}


def _one_step(params, lora, feats, tokens, opts, impl, device):
    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.train import make_optimizer, make_train_step

    cfg = _train_config(dict(opts, attn_impl=impl), epochs=2, batch_size=len(feats))
    opt = make_optimizer(cfg, steps_per_epoch=1)
    step, _ = make_train_step(VIT_B_16, cfg, opt, cached_image=True, device=device)
    loss, new, state = step(params, lora, opt.init(lora), feats, tokens)
    return float(loss), new, state, cfg.lr


# The int8 text path's card step agrees with its CPU step to a gradient
# cosine of 0.9978-0.9984 (NVIDIA H100, the first run of this check), not the
# 0.999 of bf16: the two run the same quantization sites, but their fp32 LN,
# core and bf16-product sums differ in order, so here and there an activation
# rounds to the neighbouring int8 value, and a flipped int8 quantum (1/127 of
# its row's largest value, against a bf16 ULP's 1/256 of the value itself)
# moves a whole output row of its product; over 12 layers of the
# straight-through backward at 8 rows that costs ~2e-3 of cosine. The bar is
# set at 0.995 for that path; its loss keeps the bf16 bar.
INT8_STEP_GRAD_COS = 0.995


def _step_agreement(a, b, fp32: bool, grad_cos: float = 0.999) -> dict:
    """Card step a against step b: loss, first Adam moment (0.1 x the
    gradient), updated adapters. fp32: loss rel <= 1e-5, moment within 1e-4
    of its largest entry, adapters within 1e-6 where the gradient is above
    1e-3 of its largest entry and within 4 lr elsewhere (an Adam step moves
    each element by about lr whatever its gradient's size). bf16 and the
    int8 text path: loss rel <= 2e-3, moment cosine >= ``grad_cos``,
    adapters within 4 lr."""
    import torch

    loss_rel = abs(a[0] - b[0]) / abs(b[0])
    res = {"loss": a[0], "loss_ref": b[0], "loss_rel": loss_rel, "moment": {}, "adapters": {}}
    ok = loss_rel <= (1e-5 if fp32 else 2e-3)
    lr = a[3]
    for pt in b[1]:
        for ab in "AB":
            m, mr = a[2]["exp_avg"][pt][ab].cpu(), b[2]["exp_avg"][pt][ab].cpu()
            new, newr = a[1][pt][ab].cpu(), b[1][pt][ab].cpu()
            diff = (new - newr).abs()
            if fp32:
                res["moment"][f"{pt}.{ab}"] = mv = float((m - mr).abs().max() / mr.abs().max())
                clear = mr.abs() > 1e-3 * mr.abs().max()
                res["adapters"][f"{pt}.{ab}"] = av = float(diff[clear].max())
                ok = ok and mv <= 1e-4 and av <= 1e-6 and float(diff.max()) <= 4 * lr
            else:
                res["moment"][f"{pt}.{ab}"] = mv = float(
                    torch.nn.functional.cosine_similarity(m.flatten(), mr.flatten(), dim=0))
                res["adapters"][f"{pt}.{ab}"] = av = float(diff.max())
                ok = ok and mv >= grad_cos and av <= 4 * lr
    res["ok"] = ok
    return res


def phase_train_compare(params, device) -> None:
    """Phase 8: one text-only train step (8 cached-feature rows, dense token
    rows, the same adapters) on the card against the CPU plain path for each
    training path, and block_fused against xla on the card. The int8 text
    path's weights are quantized once, on the card, and copied."""
    from aiic_tpu_torch.models.init import tree_map
    from aiic_tpu_torch.ops import _build

    saved = _build.launch_counts()
    rng = np.random.default_rng(9)
    feats, tokens = _step_batch(rng, 8, device)
    lora = _lora_init(rng, device)
    cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)  # noqa: E731
    for label, (opts, impl) in TRAIN_PATHS.items():
        t0 = time.perf_counter()
        path_params = _path_params(params, opts)
        # block_fused_int8 is reached from block_fused, which also turns remat off
        impl = opts["attn_impl"] if opts.get("quantize_text") else impl
        card = _one_step(path_params, lora, feats, tokens, opts, impl, device)
        plain = _one_step(cpu(path_params), cpu(lora), feats.cpu(), tokens.cpu(), opts, impl,
                          "cpu")
        quantized = opts.get("quantize_text", False)
        res = _step_agreement(card, plain, opts["dtype"] == "float32" and not quantized,
                              INT8_STEP_GRAD_COS if quantized else 0.999)
        log(f"[train-cpu {label}] one step card vs CPU plain ({time.perf_counter() - t0:.1f} s): "
            f"loss {res['loss']:.7f} vs {res['loss_ref']:.7f} (rel {res['loss_rel']:.3g}); "
            f"moment {res['moment']}; adapters {res['adapters']}")
        REPORT.setdefault("train_cpu_compare", {})[label] = res
        if not res["ok"]:
            raise AssertionError(f"card and CPU disagree on the {label} train step: {res}")
    opts = TRAIN_PATHS["fp32_block_fused"][0]
    block = _one_step(params, lora, feats, tokens, opts, "block_fused", device)
    xla = _one_step(params, lora, feats, tokens, opts, "xla", device)
    res = _step_agreement(block, xla, True)
    log(f"[train-xla] block_fused vs xla on the card, fp32: loss {res['loss']:.7f} vs "
        f"{res['loss_ref']:.7f} (rel {res['loss_rel']:.3g}); moment {res['moment']}")
    REPORT["train_block_vs_xla"] = res
    if not res["ok"]:
        raise AssertionError(f"block_fused and xla disagree on the card: {res}")
    for fn in _build._COUNTED.values():
        fn.launches = saved[fn.__name__]


def train_step_times(params, device, card: str) -> dict:
    """Train-step ms at batch 256 (cached image features, dense text rows,
    so the text kernels see 256 rows) on each training path."""
    import torch

    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.train import make_optimizer, make_train_step

    rng = np.random.default_rng(11)
    feats, tokens = _step_batch(rng, 256, device)
    lora = _lora_init(rng, device)
    times = {}
    for label, (opts, impl) in TRAIN_PATHS.items():
        cfg = _train_config(opts, epochs=2, batch_size=256)
        opt = make_optimizer(cfg, steps_per_epoch=4)
        step, _ = make_train_step(VIT_B_16, cfg, opt, cached_image=True, device=device)
        state, tree = opt.init(lora), lora
        path_params = _path_params(params, opts)
        loss, tree, state = step(path_params, tree, state, feats, tokens)  # warm
        torch.cuda.synchronize()
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            loss, tree, state = step(path_params, tree, state, feats, tokens)
            float(loss)
            ms.append((time.perf_counter() - t0) * 1e3)
        times[f"train_step_{label}"] = r = {"ms": min(ms), "all_ms": ms,
                                            "images_per_s": 256e3 / min(ms)}
        log(f"[timing] train step {label} ({impl}) B=256 dense rows: {r['ms']:.2f} ms "
            f"({r['images_per_s']:.1f} images/s) ({card})")
    return times


# ---------------------------------------------------------------------------
# Phase 9: timings
# ---------------------------------------------------------------------------


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# SDPA's time moved between runs of the same code: each library time is the
# median of this many repeats (10 calls each), kept with its spread.
LIBRARY_REPEATS = 5


def _library_ms(fn, iters: int = 10) -> dict:
    """The median of LIBRARY_REPEATS timings of fn, with the spread."""
    ms = sorted(_time_ms(fn, iters) for _ in range(LIBRARY_REPEATS))
    return {"library_ms": float(np.median(ms)), "library_ms_spread": [ms[0], ms[-1]],
            "library_ms_repeats": ms}


def _sdpa_times(qkv, heads: int, head_major: bool = False, mask=None) -> dict:
    """The one PyTorch call that computes the core's function:
    ``scaled_dot_product_attention`` on the same q/k/v as (B, H, S, D) (and
    the additive mask in qkv's dtype), with the transposes out of the packed
    (or head-major) layout and back timed apart from the call."""
    import torch

    bsz, seq, w3 = qkv.shape
    dim = w3 // 3 // heads
    if head_major:
        split = lambda: qkv.view(bsz, seq, heads, 3, dim).permute(3, 0, 2, 1, 4).contiguous()  # noqa: E731
    else:
        split = lambda: qkv.view(bsz, seq, 3, heads, dim).permute(2, 0, 3, 1, 4).contiguous()  # noqa: E731
    q, k, v = split()
    m = None if mask is None else mask.to(qkv.dtype)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=m)  # noqa: E731
    o = sdpa()
    merge = lambda: o.transpose(1, 2).reshape(bsz, seq, w3 // 3)  # noqa: E731
    return {**_library_ms(sdpa), "transpose_ms": _time_ms(split, 10) + _time_ms(merge, 10)}


def _engine_rate(engine, rng) -> dict:
    px = _pixels(rng, 256, engine.config.image_size)
    engine.classify_pixels(px)
    n_rep = 5
    t0 = time.perf_counter()
    for _ in range(n_rep):
        engine.classify_pixels(px)  # returns numpy: synchronised
    ips = n_rep * 256 / (time.perf_counter() - t0)
    one = _pixels(rng, 1, engine.config.image_size)
    engine.classify_pixels(one)
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        engine.classify_pixels(one)
        lat.append((time.perf_counter() - t0) * 1e3)
    return {"images_per_s_b256": ips, "single_image_p50_ms": float(np.percentile(lat, 50))}


def _kernel_times(calls, times, label: str, card: str, hold=None, worst=None) -> None:
    """plain, kernel, kernel, plain on one card, for each call. Each call
    named in ``hold`` (check name -> wrapper name) is then launched once
    more (``_one_launch``: counts at 0 before, that one launch after) and
    held against its plain version on the same inputs at the bar of
    ``_agreement``; the error goes into ``worst[name]``."""
    import torch

    hold = hold or {}
    for name, (kernel, plain, inputs, ops) in calls.items():
        t_plain = [_time_ms(plain, 3)]
        t_kernel = [_time_ms(kernel, 10), _time_ms(kernel, 10)]
        t_plain.append(_time_ms(plain, 3))
        out = _one_launch(hold[name], kernel) if name in hold else kernel()
        out = out[0] if isinstance(out, tuple) else out
        times[name] = {"ms": min(t_kernel), "plain_ms": min(t_plain), "library_ms": None,
                       **_bound(inputs, out, ops)}
        t = times[name]
        log(f"[timing] {name:24s} {label}: kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
            f"library {t['library_ms']} ms ({card})")
        if name in hold:
            a = _agreement(out, plain())
            a.update(kernel=name, case=label)
            REPORT.setdefault("timed_shape_checks", []).append(a)
            log(f"[kernels] {name:24s} {label} (timed launch) max_abs_err={a['max_abs_err']:.6g} "
                f"within_2ulp={a['within_2ulp']:.6f} min_row_cos={a['min_row_cos']:.8f}")
            if not a["ok"]:
                raise AssertionError(f"{name} disagrees with its plain version on {label}: {a}")
            worst[name] = max(worst.get(name, 0.0), a["max_abs_err"])
        del out
        torch.cuda.empty_cache()


def _sdpa_bshd_times(q, k, v, mask) -> dict:
    """``scaled_dot_product_attention`` on the same (B, S, H, D) q, k, v as
    (B, H, S, D) with the additive mask in q's dtype; the transposes there
    and back timed apart."""
    import torch

    split = lambda: [t.transpose(1, 2).contiguous() for t in (q, k, v)]  # noqa: E731
    qh, kh, vh = split()
    m = None if mask is None else mask.to(q.dtype)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=m)  # noqa: E731
    o = sdpa()
    merge = lambda: o.transpose(1, 2).contiguous()  # noqa: E731
    return {**_library_ms(sdpa), "transpose_ms": _time_ms(split, 10) + _time_ms(merge, 10)}


# torch.profiler (PyTorch 2.11, CUDA 12.8, on an H100) drops the first kernel
# records of a trace, the more the older the process, and now and then many
# more: ``tools/profiler_loss.py`` shows it. Each trace opens with
# PROFILE_LEAD_IN throwaway spin kernels (about 22 ms of device time), which
# take the loss in most traces; ``_device_ms_by_kernel`` uses a trace only
# when it is whole and the one before it counted the same kernels, and fails
# the run after PROFILE_TRIES traces.
PROFILE_ITERS = 3
PROFILE_LEAD_IN = 400
PROFILE_TRIES = 5


def _trace(fn, lead_in: int = PROFILE_LEAD_IN) -> list:
    """The CUDA kernel events (``key_averages``) of one ``torch.profiler``
    trace of PROFILE_ITERS calls of fn(), opened by ``lead_in`` spin
    kernels, whose events are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(lead_in):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        for _ in range(PROFILE_ITERS):
            fn()
        torch.cuda.synchronize()
    return [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in ev.key]


def _device_ms_by_kernel(fn, needles: dict) -> dict:
    """Device ms per call of fn() spent in the CUDA kernels whose names hold
    each needle, from ``_trace`` (None where the trace shows no such
    kernel). A trace is whole when it shows device time, every kernel's
    count is a multiple of the calls, and it holds as many
    ``wgmma_stage_kernel`` launches as ``quant.gemm_stage`` counted in it
    and rows 5, 10 and 11-14 launched inside theirs (``BF16_STAGE_LAUNCHES``);
    the one used is whole and counts what the whole trace before it
    counted."""
    import torch

    from aiic_tpu_torch.ops import _build

    def stage_launches():
        counts = _build.launch_counts()
        return counts.get("gemm_stage", 0) + sum(n * counts.get(k, 0)
                                                 for k, n in BF16_STAGE_LAUNCHES.items())

    fn()
    torch.cuda.synchronize()
    before = None
    for _ in range(PROFILE_TRIES):
        counted = stage_launches()
        events = _trace(fn)
        counted = stage_launches() - counted
        stage = sum(ev.count for ev in events if "wgmma_stage_kernel" in ev.key)
        counts = {ev.key: ev.count for ev in events}
        whole = bool(events) and stage == counted and all(
            n % PROFILE_ITERS == 0 for n in counts.values())
        if whole and counts == before:
            break
        if not whole:
            log(f"[profile] a trace that is not whole: {counted} stage launches counted, {stage} "
                f"traced, counts {list(counts.values())} over {PROFILE_ITERS} calls")
        before = counts if whole else None
    else:
        raise AssertionError(f"{PROFILE_TRIES} traces of one call: no two whole ones in a row "
                             f"agree; the last counted {counts}")
    out = {k: None for k in needles}
    for ev in events:
        for k, needle in needles.items():
            if needle in ev.key:
                out[k] = (out[k] or 0.0) + ev.self_device_time_total / 1e3 / PROFILE_ITERS
    return out


def _bwd_yardsticks(qkv, mask, g, heads: int) -> dict:
    """Row 9's two comparisons: the backward that ``pallas_vjp`` runs today
    (``_AttentionQKVVJP.backward``: the stable composition recomputed at qkv
    and differentiated by autograd), and ``torch.autograd.grad`` through
    ``scaled_dot_product_attention`` on the same q, k, v with the additive
    mask (its forward kept; the transposes out of and back into the packed
    layout timed apart)."""
    import torch

    from aiic_tpu_torch.ops import attention

    bsz, seq, w3 = qkv.shape
    dim = w3 // 3 // heads

    def autograd():
        with torch.enable_grad():
            t = qkv.detach().requires_grad_()
            return torch.autograd.grad(attention.attention_qkv_ref(t, mask, heads), t, g)[0]

    split = lambda: [t.contiguous() for t in qkv.view(bsz, seq, 3, heads, dim).permute(2, 0, 3, 1, 4)]  # noqa: E731
    go_split = lambda: g.view(bsz, seq, heads, dim).transpose(1, 2).contiguous()  # noqa: E731
    with torch.enable_grad():
        qh, kh, vh = (t.detach().requires_grad_() for t in split())
        o = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=None if mask is None else mask.to(qkv.dtype))
    go = go_split()
    bwd = lambda: torch.autograd.grad(o, (qh, kh, vh), go, retain_graph=True)  # noqa: E731
    grads = bwd()
    merge = lambda: torch.stack(grads, 2).permute(0, 3, 2, 1, 4).reshape(bsz, seq, w3)  # noqa: E731
    res = {"autograd_ms": min(_time_ms(autograd, 3), _time_ms(autograd, 3)), **_library_ms(bwd),
           "transpose_ms": _time_ms(split, 10) + _time_ms(go_split, 10) + _time_ms(merge, 10)}
    del o, grads
    return res


def _row9_step_times(params, device, card: str) -> dict:
    """One fp32 ``pallas_vjp`` train step at 256 dense text rows (cached
    image features) as shipped and with row 9 as the core's backward, in
    turns (shipped, row 9, row 9, shipped; 3 timed steps after one each);
    the first row 9 step launches exactly 24 row 7 forwards (12 and 12
    recomputed under remat) and 11 row 9 backwards (the first block's qkv
    needs no gradient: its input carries none and LoRA attaches after the
    core), and its loss, gradient and update agree with the shipped step's
    at the fp32 step bar."""
    import torch

    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.ops import attention
    from aiic_tpu_torch.ops._build import launch_counts, reset_launch_counts
    from aiic_tpu_torch.train import make_optimizer, make_train_step

    class Row9VJP(torch.autograd.Function):
        """The ``pallas_vjp`` core with row 9 as its backward, made here to
        time the swap; the package keeps the JAX pairing."""

        @staticmethod
        def forward(ctx, qkv, mask, heads):
            ctx.heads = heads
            ctx.save_for_backward(qkv, mask)
            return attention.fused_attention_qkv(qkv, mask, heads=heads)

        @staticmethod
        def backward(ctx, g):
            qkv, mask = ctx.saved_tensors
            return attention.fused_attention_qkv_bwd(qkv, mask, g, heads=ctx.heads), None, None

    rng = np.random.default_rng(11)
    feats, tokens = _step_batch(rng, 256, device)
    lora = _lora_init(rng, device)
    cfg = _train_config(TRAIN_PATHS["fp32_auto"][0], epochs=2, batch_size=256)
    opt = make_optimizer(cfg, steps_per_epoch=4)
    step, _ = make_train_step(VIT_B_16, cfg, opt, cached_image=True, device=device)
    shipped = attention.fused_attention_qkv_vjp
    first, ms = {}, {"shipped": [], "row9": []}
    for variant in ("shipped", "row9", "row9", "shipped"):
        attention.fused_attention_qkv_vjp = Row9VJP.apply if variant == "row9" else shipped
        try:
            reset_launch_counts()
            loss, tree, state = step(params, lora, opt.init(lora), feats, tokens)
            torch.cuda.synchronize()
            counts = {n: c for n, c in launch_counts().items() if c}
            first.setdefault(variant, ((float(loss), tree, state, cfg.lr), counts))
            for _ in range(3):
                t0 = time.perf_counter()
                loss, tree, state = step(params, tree, state, feats, tokens)
                float(loss)
                ms[variant].append((time.perf_counter() - t0) * 1e3)
        finally:
            attention.fused_attention_qkv_vjp = shipped
    want = {"fused_attention_qkv": 24, "fused_attention_qkv_bwd": 11}
    if first["row9"][1] != want or first["shipped"][1] != {"fused_attention_qkv": 24}:
        raise AssertionError(f"row 9 step launches {first['row9'][1]} (want {want}), shipped "
                             f"{first['shipped'][1]}")
    agree = _step_agreement(first["row9"][0], first["shipped"][0], True)
    res = {"train_step_fp32_pallas_vjp_shipped": {"ms": min(ms["shipped"]), "all_ms": ms["shipped"]},
           "train_step_fp32_pallas_vjp_row9": {"ms": min(ms["row9"]), "all_ms": ms["row9"],
                                               "launches": first["row9"][1], "vs_shipped": agree}}
    log(f"[timing] train step fp32 pallas_vjp B=256: shipped {res['train_step_fp32_pallas_vjp_shipped']['ms']:.2f} "
        f"ms {ms['shipped']}, row 9 backward {res['train_step_fp32_pallas_vjp_row9']['ms']:.2f} ms "
        f"{ms['row9']}; row 9 step vs shipped: loss rel {agree['loss_rel']:.3g}, moment "
        f"{agree['moment']} ({card})")
    if not agree["ok"]:
        raise AssertionError(f"the step with row 9 disagrees with the shipped one: {agree}")
    return res


def phase_core_ops_timing(device, card: str, params, worst: dict) -> dict:
    """Phase 9 for rows 6, 9 and 17: row 6 at 256 ViT-B/16 images beside
    SDPA; row 9 at 256 text rows (S=77, causal: the train step's shape) and
    at 256 ViT-B/16 images beside the autograd backward and SDPA's, and
    beside the scalar forms the tensor-core (bf16) and register-tiled (fp32)
    ones replaced (the one-tile form at S=77, the streaming form at both),
    with device ms by pass; bf16 row 6 and row 9 in both types held against
    their plain versions at the timed shapes (``worst`` takes the errors); the probe
    kernels (wgmma) at the TPU probe's geometry beside the WMMA form they
    replaced and the library's products, held against their plain versions,
    with device ms by stage; the ``pallas_vjp`` step with and without row 9.
    Launch counts are put back."""
    import torch

    from aiic_tpu_torch.ops import _build, attention
    from aiic_tpu_torch.probes import mxu_probe

    saved = _build.launch_counts()
    gen = torch.Generator(device=device).manual_seed(31)
    times = {}
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        shape, kind = (256, 197, 12, 64), ("fp32" if dtype == torch.float32 else "bf16")
        q, k, v = (_randn(gen, shape, dtype, device) for _ in range(3))
        name = "fused_attention" + suffix
        hold = {name: "fused_attention"}
        _kernel_times({name: (lambda: attention.flash_attention(q, k, v),
                              lambda: attention.fused_attention_ref(q, k, v), (q, k, v),
                              {kind: 4 * 256 * 12 * 197 * 197 * 64})},
                      times, f"B=256 S=197 H=12 D=64 {kind}", card, hold=hold, worst=worst)
        times[name].update(_sdpa_bshd_times(q, k, v, None))
        log(f"[timing] {name:24s} SDPA median {times[name]['library_ms']:.3f} ms (spread "
            f"{times[name]['library_ms_spread']}), transposes {times[name]['transpose_ms']:.3f} ms "
            f"({card})")
        if dtype == torch.float32:
            _f32_core_forms(times[name], name, card,
                            lambda form: attention._fused_attention_cuda(q, k, v, None, form))
        del q, k, v
        for tag, (bsz, seq, heads, causal) in (("_text", (256, 77, 8, True)),
                                               ("_vit", (256, 197, 12, False))):
            qkv, g, mask = _row9_inputs(gen, bsz, seq, heads, causal, dtype, device)
            name = "fused_attention_qkv_bwd" + tag + suffix
            _kernel_times({name: (
                lambda: attention.fused_attention_qkv_bwd(qkv, mask, g, heads=heads),
                lambda: attention.fused_attention_qkv_bwd_ref(qkv, mask, g, heads=heads),
                (qkv, mask, g), {kind: 10 * bsz * heads * seq * seq * 64})},
                times, f"B={bsz} S={seq} H={heads} {kind}", card,
                hold={name: "fused_attention_qkv_bwd"}, worst=worst)
            times[name].update(_bwd_yardsticks(qkv, mask, g, heads))
            t = times[name]
            log(f"[timing] {name:24s} autograd backward (pallas_vjp) {t['autograd_ms']:.3f} ms, "
                f"SDPA backward median {t['library_ms']:.3f} ms (spread {t['library_ms_spread']}), "
                f"transposes {t['transpose_ms']:.3f} ms "
                f"({card})")
            # The scalar forms the tensor-core (bf16) or register-tiled (fp32)
            # one replaced, then that one again, in this run; its device ms
            # by pass.
            form, kernel_name = (("mma", "core_bwd_mma") if dtype == torch.bfloat16
                                 else ("tiled", "core_bwd_tiled"))
            forms = ("one_tile", "streaming") if seq <= attention._BWD_TILE_ROWS else (
                "streaming",)
            t["replaced_forms_ms"] = {
                f: min(_time_ms(lambda: attention._fused_attention_qkv_bwd_cuda(
                    qkv, mask, g, heads, f), 5) for _ in range(2)) for f in forms}
            t[form + "_ms_after"] = min(_time_ms(lambda: attention.fused_attention_qkv_bwd(
                qkv, mask, g, heads=heads), 10) for _ in range(2))
            t["pass_device_ms"] = _device_ms_by_kernel(
                lambda: attention.fused_attention_qkv_bwd(qkv, mask, g, heads=heads),
                {"query_pass": kernel_name + "_query_kernel", "key_pass": kernel_name + "_key_kernel"})
            log(f"[timing] {name:24s} replaced scalar forms {t['replaced_forms_ms']} ms, the "
                f"{form} form timed after them {t[form + '_ms_after']:.3f} ms; device ms by pass "
                f"(profiler) {t['pass_device_ms']} ({card})")
            del qkv, g
            torch.cuda.empty_cache()
    times["fused_attention_qkv_bwd"] = times["fused_attention_qkv_bwd_text"]
    x_bf, x_i8, w_bf, w_i8 = mxu_probe.inputs(device)
    operands = {"mxu_bf16": (x_bf, w_bf), "mxu_i8": (x_i8, w_i8), "mxu_i8_quant": (x_bf, w_i8)}
    stages = {"mxu_bf16": {"products": "mxu_wgmma_kernel"},
              "mxu_i8": {"products": "mxu_wgmma_kernel"},
              "mxu_i8_quant": {"row_pass": "mxu_quant_rows_kernel",
                               "products": "mxu_wgmma_quant_kernel"}}
    ops = 2 * x_bf.shape[0] * mxu_probe.W * mxu_probe.M * mxu_probe.INNER
    for name, (kernel, wmma, libraries, kind) in mxu_probe.bodies(x_bf, x_i8, w_bf, w_i8).items():
        x, w = operands[name]
        plain = getattr(mxu_probe, name + "_ref")
        _kernel_times({name: (kernel, lambda: plain(x, w, mxu_probe.INNER), (x, w), {kind: ops})},
                      times, f"{x.shape[0]} rows x {mxu_probe.INNER} products", card,
                      hold={name: name}, worst=worst)
        t = times[name]
        t["tera_ops_per_s"] = ops / t["ms"] / 1e9
        # The WMMA form the wgmma one replaced, then the wgmma one again.
        t["wmma_ms"] = min(_time_ms(wmma, 2), _time_ms(wmma, 2))
        t["wgmma_ms_after"] = min(_time_ms(kernel, 3), _time_ms(kernel, 3))
        t["stage_device_ms"] = _device_ms_by_kernel(kernel, stages[name])
        t["library_ms_by_w_layout"] = {layout: min(_time_ms(lib, 2), _time_ms(lib, 2))
                                       for layout, lib in libraries.items()}
        t["library_ms"] = min(t["library_ms_by_w_layout"].values(), default=None)
        log(f"[timing] {name:24s} {t['tera_ops_per_s']:.1f} T(FL)OP/s of the {kind} peak "
            f"{mxu_probe.PEAK_OPS[kind] / 1e12:.1f}; WMMA form {t['wmma_ms']:.3f} ms, the wgmma "
            f"form after it {t['wgmma_ms_after']:.3f} ms; device ms by stage (profiler) "
            f"{t['stage_device_ms']}; library by w layout {t['library_ms_by_w_layout']} ms ({card})")
    times.update(_row9_step_times(params, device, card))
    for fn in _build._COUNTED.values():
        fn.launches = saved[fn.__name__]
    REPORT.setdefault("timing", {}).update(times)
    return times


def _f32_core_forms(t: dict, name: str, card: str, call) -> None:
    """fp32 rows 6-7: the scalar core that the register-tiled one replaced
    (``call("scalar")``, uncounted), then the register-tiled one again
    (``call(None)``), in this run; min of two runs of 10 each."""
    t["scalar_ms"] = min(_time_ms(lambda: call("scalar"), 10) for _ in range(2))
    t["tiled_ms_after"] = min(_time_ms(lambda: call(None), 10) for _ in range(2))
    log(f"[timing] {name:24s} scalar core it replaced {t['scalar_ms']:.3f} ms, the register-tiled "
        f"core timed after it {t['tiled_ms_after']:.3f} ms ({card})")


# Device time of rows 1, 2, 5 and 10 by stage: kernel-name needles of both
# forms (the int8 rows' LN row quantizer, the bf16 rows' LN row pass).
ROW_STAGE_NEEDLES = {"row_pass": "rowquant_kernel", "ln_pass": "ln_rows_kernel",
                     "wgmma_stage": "wgmma_stage_kernel", "wmma_gemm": "gemm_kernel<",
                     "core_mma": "attn_core_mma_kernel", "core_scalar": "attn_core_kernel<"}


def _row_forms_times(p, calls, times: dict, card: str, worst: dict) -> None:
    """Phase 9 for rows 1, 2, 5 and 10 and their GEMM stage, at B=256
    ViT-B/16: the stage alone on each of the seven products
    (``_kernel_times``: plain, kernel, kernel, plain; the bound of the
    product and its epilogue's bytes; held against its plain version) beside
    the WMMA stage it replaced and the stage yardstick (``torch._int_mm``,
    ``torch.matmul``: the product without the epilogue, the median of 5),
    with its rate; then for each row (timed by the caller) its new form again
    and right after it its WMMA form on the same inputs, the sum of its two
    products' yardsticks, and both forms' device ms by stage
    (``torch.profiler``). The new forms must launch no WMMA GEMM and no
    scalar core."""
    from aiic_tpu_torch.ops import attention, mlp, quant

    h = p["heads"]
    attn_q = calls["int8_ln_qkv_attention"][2]
    mlp_q = calls["int8_ln_mlp"][2]
    attn_b = calls["fused_ln_qkv_attention"][2]
    mlp_b = calls["fused_ln_mlp"][2]
    products = {**_stage_products(p), **_bf16_stage_products(p)}
    stage: dict = {}
    _kernel_times(_stage_calls(products), stage, "B=256 S=197 W=768 (stage)", card,
                  hold={name: "gemm_stage" for name in products}, worst=worst)
    for name, prod in products.items():
        t = stage[name]
        t["wmma_ms"] = min(_time_ms(lambda: _stage_wmma(prod), 10) for _ in range(2))
        lib = _library_ms(_stage_library(prod))
        t["yardstick_ms"], t["yardstick_ms_spread"] = lib["library_ms"], lib["library_ms_spread"]
        t["rate_t_per_s"] = sum(prod[4].values()) / t["ms"] / 1e9
        log(f"[timing] {name:24s} wgmma stage {t['ms']:.3f} ms ({t['rate_t_per_s']:.1f} T/s on "
            f"its operations), WMMA stage {t['wmma_ms']:.3f} ms, yardstick "
            f"({'torch.matmul' if prod[2] in quant.BF16_EPILOGUES else 'torch._int_mm'}, no "
            f"epilogue) {t['yardstick_ms']:.3f} ms (spread {t['yardstick_ms_spread']}) ({card})")
    times.update(stage)
    c_fc = times["gemm_stage_c_fc"]  # the kernels line's entry: the largest product
    times["gemm_stage"] = dict(c_fc, products={k: {f: stage[k][f] for f in (
        "ms", "plain_ms", "bound_ms", "bound_by", "wmma_ms", "yardstick_ms", "rate_t_per_s")}
        for k in products})
    forms = {"int8_ln_qkv_attention": (
                 lambda: quant._int8_ln_qkv_attention_cuda(*attn_q, h, 1e-5, "wmma"),
                 ("gemm_stage_qkv", "gemm_stage_out_proj")),
             "int8_ln_mlp": (lambda: quant._int8_ln_mlp_cuda(*mlp_q, 1e-5, 1, "wmma"),
                             ("gemm_stage_c_fc", "gemm_stage_c_proj")),
             "fused_ln_qkv_attention": (
                 lambda: attention._fused_ln_qkv_attention_cuda(*attn_b, h, 1e-5, "wmma"),
                 ("gemm_stage_bf16_qkv", "gemm_stage_out_proj")),
             "fused_ln_mlp": (lambda: mlp._fused_ln_mlp_cuda(*mlp_b, 1e-5, "wmma"),
                              ("gemm_stage_bf16_c_fc", "gemm_stage_bf16_c_proj"))}
    for name, (wmma, prods) in forms.items():
        t = times[name]
        t["ms_beside_wmma"] = min(_time_ms(calls[name][0], 10) for _ in range(2))
        t["wmma_ms"] = min(_time_ms(wmma, 10) for _ in range(2))
        t["stage_yardstick_ms"] = sum(stage[k]["yardstick_ms"] for k in prods)
        t["device_ms_by_stage"] = _device_ms_by_kernel(calls[name][0], ROW_STAGE_NEEDLES)
        t["wmma_device_ms_by_stage"] = _device_ms_by_kernel(wmma, ROW_STAGE_NEEDLES)
        log(f"[timing] {name:24s} new form {t['ms']:.3f} ms ({t['ms_beside_wmma']:.3f} right "
            f"before the WMMA form), WMMA form {t['wmma_ms']:.3f} ms, "
            f"plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms, stage yardstick "
            f"{t['stage_yardstick_ms']:.3f} ms; device ms by stage {t['device_ms_by_stage']}, "
            f"WMMA form {t['wmma_device_ms_by_stage']} ({card})")
        d = t["device_ms_by_stage"]
        if d["wmma_gemm"] is not None or d["core_scalar"] is not None or d["wgmma_stage"] is None:
            raise AssertionError(f"{name}: the new form launched {d}")


def _bf16_text_forms(device, times: dict, card: str) -> None:
    """Rows 5 and 10 at the bf16 text tower's build shape (52 prompts, S=77,
    W=512, causal): the new form (through the wrapper) and right after it
    the WMMA form on the same inputs, the best of two 10-call runs each;
    4,004 rows make 32 x 12 QKV tiles, so both may be host-bound."""
    from aiic_tpu_torch.ops import attention, mlp

    p = _half_block_inputs(np.random.default_rng(9), 52, 77, 512, 8, mask=True, zero_row=False,
                           device=device)
    attn_b = (p["x"], p["ln_s"], p["ln_b"], p["wqkv_b"], p["bqkv"], p["wo"], p["bo"], p["mask"])
    mlp_b = (p["x"], p["ln_s"], p["ln_b"], p["w1_b"], p["b1"], p["w2_b"], p["b2"])
    forms = {"fused_ln_qkv_attention": (
                 lambda: attention.fused_ln_qkv_attention(*attn_b, heads=8),
                 lambda: attention._fused_ln_qkv_attention_cuda(*attn_b, 8, 1e-5, "wmma")),
             "fused_ln_mlp": (lambda: mlp.fused_ln_mlp(*mlp_b),
                              lambda: mlp._fused_ln_mlp_cuda(*mlp_b, 1e-5, "wmma"))}
    for name, (new, wmma) in forms.items():
        t = times[name]["text"] = {
            "ms": min(_time_ms(new, 10) for _ in range(2)),
            "wmma_ms": min(_time_ms(wmma, 10) for _ in range(2))}
        log(f"[timing] {name:24s} B=52 S=77 W=512 causal: new form {t['ms']:.3f} ms, WMMA form "
            f"{t['wmma_ms']:.3f} ms ({card})")


# Device time of rows 11-14 by stage, both forms and fp32: kernel-name
# needles (the WMMA gemm_kernel apart from the SIMT rank-r and fp32 tiles,
# whose names end in gemm_kernel too; the fold is a stage kernel, shown again
# alone; "rank_r" the rank_down / rank_cot kernels of form 0 and fp32,
# "rank_r_first" form 1's 64x16 tile).
BLOCK_STAGE_NEEDLES = {"wgmma_stage": "wgmma_stage_kernel", "of_which_fold": "EpiChunkRowScale",
                       "wmma_gemm": "::gemm_kernel<", "sgemm": "sgemm_kernel",
                       "core_bwd_mma": "core_bwd_mma_", "core_bwd_tiled": "core_bwd_tiled_",
                       "core_bwd_scalar": "block_core_bwd_kernel",
                       "core_fwd_mma": "block_core_fwd_mma_kernel",
                       "core_fwd_f32": "attn_core_f32_kernel",
                       "core_fwd_scalar": "block_core_fwd_kernel<", "rank_r": "rank_",
                       "rank_r_first": "simt_gemm_kernel<", "rank_r_sums": "sum_partials_kernel",
                       "ln_fwd": "ln_fwd_rows_kernel", "ln_bwd": "ln_bwd_rows_kernel",
                       "row_quant": "rowquant"}


def _rank_core_times(device, times: dict, card: str) -> None:
    """Rows 11-14's redesigned pieces alone at 256 text rows (B/16: W=512,
    M=2048, rank 16), each against its plain version (``_kernel_times``:
    plain, kernel, kernel, plain; the bound of its bytes and operations)
    and right after it on the same inputs its first design, the best of two
    10-call runs: every rank-r product of ``_rank_shapes`` in bf16 (a in
    fp32 where the int8 block passes one) and fp32 beside narrow_gemm; the
    tensor-core core forward beside block_core_fwd_kernel (causal, qkv of
    256 images)."""
    import torch

    from aiic_tpu_torch.models.clip import causal_mask
    from aiic_tpu_torch.ops import block_grad

    gen = torch.Generator(device=device).manual_seed(16)
    calls, first = {}, {}
    for fp32 in (False, True):
        dtype = torch.float32 if fp32 else torch.bfloat16
        for name, kind, a_shape, b_shape, trans, a_f32 in _rank_shapes(256 * 77, 512):
            a = torch.randn(a_shape, generator=gen, device=device)
            a = a if (fp32 or a_f32) else a.to(dtype)
            b = torch.randn(b_shape, generator=gen, device=device).to(dtype)
            kw = dict(trans=trans, scaling=2.0)
            key = f"rank_{name}_{'fp32' if fp32 else 'bf16'}"
            calls[key] = (
                lambda a=a, b=b, kind=kind, kw=kw: block_grad.rank_product_cuda(a, b, kind, **kw),
                lambda a=a, b=b, kind=kind, kw=kw, dtype=dtype: block_grad.rank_product_ref(
                    a, b, kind, dtype=dtype, **kw),
                (a, b), {"fp32" if fp32 else "bf16": 2 * a_shape[0] * a_shape[1] * 16})
            first[key] = (lambda a=a, b=b, kind=kind, kw=kw: block_grad.rank_product_cuda(
                a, b, kind, form="wmma", **kw))
    qkv = torch.randn((256, 77, 1536), generator=gen, device=device).to(torch.bfloat16)
    mask = causal_mask(77, device=device)
    calls["core_fwd_mma"] = (lambda: block_grad.block_core_fwd_cuda(qkv, mask, 8),
                             lambda: block_grad.block_core_fwd_ref(qkv, mask, 8), (qkv, mask),
                             {"bf16": 4 * 256 * 8 * 77 * 77 * 64})
    first["core_fwd_mma"] = lambda: block_grad.block_core_fwd_cuda(qkv, mask, 8, form="wmma")
    _kernel_times(calls, times, "B=256 S=77 W=512 (rows 11-14's pieces)", card)
    for key, fn in first.items():
        t = times[key]
        t["first_ms"] = min(_time_ms(fn, 10) for _ in range(2))
        log(f"[timing] {key:24s} form 0 {t['ms']:.4f} ms, first design (narrow_gemm / "
            f"block_core_fwd_kernel) {t['first_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}) ({card})")
    REPORT["rank_core_timing"] = {k: times[k] for k in calls}


# Row 12 fp32's backbone products at 256 text rows: (label, K, N, w read
# as (N, K)); row 11 fp32 runs the first three and c_proj.
F32_PRODUCTS = [("qkv", 512, 1536, False), ("out_proj", 512, 512, False),
                ("c_fc", 512, 2048, False), ("c_proj", 2048, 512, False),
                ("dy.W2^T", 512, 2048, True), ("dfq.W1^T", 2048, 512, True),
                ("dy1.Wo^T", 512, 512, True), ("dqkv.Wqkv^T", 1536, 512, True)]


def _f32_block_times(device, times: dict, card: str) -> None:
    """fp32 rows 11-12 at 256 text rows: the device ms by stage of one call
    each (the private launch functions, uncounted), and their stage
    yardstick: each backbone product alone on the SIMT tile
    (``text_sgemm_cuda``, no epilogue) beside cuBLAS SGEMM on the same fp32
    operands with TF32 off (``torch.matmul``, the median of 5), summed over
    the products each row runs (row 11: QKV, out-projection, c_fc, c_proj;
    row 12: the recomputed forward's first three and the four input-gradient
    products)."""
    import torch

    from aiic_tpu_torch.ops import attention, block_grad

    attention.no_tf32()
    p = _text_block_inputs(np.random.default_rng(12), 256, torch.float32, device)
    a = (p["heads"], 2.0, 1e-5)
    args = (p["x"], p["mask"], p["bp"], p["lora"])
    stages = {"text_block_fwd": _device_ms_by_kernel(
                  lambda: block_grad._text_block_fwd_cuda(*args, *a), BLOCK_STAGE_NEEDLES),
              "text_block_bwd": _device_ms_by_kernel(
                  lambda: block_grad._text_block_bwd_cuda(args[0], p["dy"], *args[1:], *a),
                  BLOCK_STAGE_NEEDLES)}
    gen = torch.Generator(device=device).manual_seed(17)
    prods = {}
    for label, k, n, trans in F32_PRODUCTS:
        x = torch.randn((256 * 77, k), generator=gen, device=device)
        w = torch.randn((n, k) if trans else (k, n), generator=gen, device=device)
        lib = _library_ms(lambda: x @ (w.t() if trans else w))
        prods[label] = {"tile_ms": min(_time_ms(lambda: block_grad.text_sgemm_cuda(
                            x, w, trans=trans), 10) for _ in range(2)),
                        "cublas_ms": lib["library_ms"],
                        "cublas_ms_spread": lib["library_ms_spread"],
                        "gflop": 2 * 256 * 77 * k * n / 1e9}
        q = prods[label]
        log(f"[timing] fp32 backbone product {label:12s} K={k} N={n}: SIMT tile {q['tile_ms']:.4f} "
            f"ms ({q['gflop'] / q['tile_ms']:.1f} TFLOP/s), cuBLAS SGEMM (TF32 off) "
            f"{q['cublas_ms']:.4f} ms ({q['gflop'] / q['cublas_ms']:.1f}) ({card})")
        del x, w
    rows = {"text_block_fwd": ("qkv", "out_proj", "c_fc", "c_proj"),
            "text_block_bwd": ("qkv", "out_proj", "c_fc", "dy.W2^T", "dfq.W1^T", "dy1.Wo^T",
                               "dqkv.Wqkv^T")}
    for name, labels in rows.items():
        t = times[name]
        t["device_ms_by_stage"] = stages[name]
        t["tile_ms"] = sum(prods[q]["tile_ms"] for q in labels)
        t["stage_yardstick_ms"] = sum(prods[q]["cublas_ms"] for q in labels)
        log(f"[timing] {name:24s} fp32 B=256 S=77 W=512: {t['ms']:.3f} ms; device ms by stage "
            f"{stages[name]}; its products on the SIMT tile alone {t['tile_ms']:.3f} ms, stage "
            f"yardstick (cuBLAS SGEMM, TF32 off) {t['stage_yardstick_ms']:.3f} ms ({card})")
    REPORT["f32_products"] = prods


def _block_forms_times(p, times: dict, card: str) -> None:
    """Rows 11-14 at 256 text rows (B/16: S=77, W=512, M=2048, H=8, rank 16)
    on the bf16 weights of ``p`` and their int8 quantization: form 0 through
    the counted wrapper and right after it, on the same inputs, form 1 (the
    first design, uncounted), the best of two 10-call runs each, with both
    forms' device ms by stage (``_device_ms_by_kernel``, checked traces)."""
    from aiic_tpu_torch.ops import block_grad

    x, dy, mask, bp, lora, qw = p["x"], p["dy"], p["mask"], p["bp"], p["lora"], p["qw"]
    kw, a = dict(heads=8, scaling=2.0), (8, 2.0, 1e-5)
    c = block_grad._int8_chunks(x, 2048, 8, None)
    forms = {
        "text_block_fwd_bf16": (
            lambda: block_grad.text_block_fwd(x, mask, bp, lora, **kw),
            lambda: block_grad._text_block_fwd_cuda(x, mask, bp, lora, *a, "wmma")),
        "text_block_bwd_bf16": (
            lambda: block_grad.text_block_bwd(x, dy, mask, bp, lora, **kw),
            lambda: block_grad._text_block_bwd_cuda(x, dy, mask, bp, lora, *a, "wmma")),
        "text_block_fwd_int8": (
            lambda: block_grad.text_block_fwd_int8(x, mask, bp, qw, lora, **kw),
            lambda: block_grad._text_block_fwd_int8_cuda(x, mask, bp, qw, lora, *a, "wmma")),
        "text_block_bwd_int8": (
            lambda: block_grad.text_block_bwd_int8(x, dy, mask, bp, qw, lora, **kw),
            lambda: block_grad._text_block_bwd_int8_cuda(x, dy, mask, bp, qw, lora, *a, c,
                                                         "wmma")),
    }
    for name, (new, wmma) in forms.items():
        t = times[name]
        t["ms_before_wmma"] = min(_time_ms(new, 10) for _ in range(2))
        t["wmma_ms"] = min(_time_ms(wmma, 10) for _ in range(2))
        t["device_ms_by_stage"] = _device_ms_by_kernel(new, BLOCK_STAGE_NEEDLES)
        t["wmma_device_ms_by_stage"] = _device_ms_by_kernel(wmma, BLOCK_STAGE_NEEDLES)
        log(f"[timing] {name:24s} B=256 S=77 W=512: form 0 {t['ms_before_wmma']:.3f} ms, form 1 "
            f"(WMMA, scalar core backward) {t['wmma_ms']:.3f} ms; device ms by stage form 0 "
            f"{t['device_ms_by_stage']}, form 1 {t['wmma_device_ms_by_stage']} ({card})")


def phase_timing(device, card: str, engines, params, worst: dict) -> dict:
    """Phase 9. Launches made here are not the paths': the counts are
    saved before and put back after. Row 7 (fp32 and bf16 at B/16, fp32 at
    256 text rows, bf16 at L/14) is held against its plain version at the
    timed shapes; ``worst`` takes the errors. fp32 row 7 is timed beside the
    scalar core it replaced, and every SDPA time is a median with its
    spread."""
    import torch

    from aiic_tpu_torch.models.clip import causal_mask
    from aiic_tpu_torch.ops import _build, attention

    p = _half_block_inputs(np.random.default_rng(3), 256, 197, 768, 12,
                           mask=False, zero_row=False, device=device)
    times = {}
    saved = _build.launch_counts()
    calls = _calls(p)
    _kernel_times(calls, times, "B=256 S=197 W=768", card, worst=worst,
                  hold={"fused_attention_qkv": "fused_attention_qkv",
                        "fused_attention_qkv_bf16": "fused_attention_qkv",
                        "int8_ln_qkv_attention": "int8_ln_qkv_attention",
                        "int8_ln_mlp": "int8_ln_mlp",
                        "fused_ln_qkv_attention": "fused_ln_qkv_attention",
                        "fused_ln_mlp": "fused_ln_mlp"})
    _row_forms_times(p, calls, times, card, worst)
    _bf16_text_forms(device, times, card)
    for name in ("fused_attention_qkv", "fused_attention_qkv_bf16"):
        times[name].update(_sdpa_times(calls[name][2][0], p["heads"]))
        log(f"[timing] {name:24s} SDPA median {times[name]['library_ms']:.3f} ms (spread "
            f"{times[name]['library_ms_spread']}), transposes {times[name]['transpose_ms']:.3f} ms "
            f"({card})")
    _f32_core_forms(times["fused_attention_qkv"], "fused_attention_qkv", card,
                    lambda form: attention._fused_attention_qkv_cuda(p["qkv"], None, 12, form))
    del p, calls
    # fp32 row 7 at the pallas_vjp step's shape (256 text rows, causal).
    gen = torch.Generator(device=device).manual_seed(8)
    qkv = torch.randn((256, 77, 1536), generator=gen, device=device)
    mask = causal_mask(77, device=device)
    name = "fused_attention_qkv_text"
    _kernel_times({name: (lambda: attention.fused_attention_qkv(qkv, mask, heads=8),
                          lambda: attention.fused_attention_qkv_ref(qkv, mask, 8), (qkv, mask),
                          {"fp32": 4 * 256 * 8 * 77 * 77 * 64})},
                  times, "B=256 S=77 W=512 causal fp32", card, worst=worst,
                  hold={name: "fused_attention_qkv"})
    times[name].update(_sdpa_times(qkv, 8, mask=mask))
    log(f"[timing] {name} SDPA median {times[name]['library_ms']:.3f} ms (spread "
        f"{times[name]['library_ms_spread']}), transposes {times[name]['transpose_ms']:.3f} ms "
        f"({card})")
    _f32_core_forms(times[name], name, card,
                    lambda form: attention._fused_attention_qkv_cuda(qkv, mask, 8, form))
    del qkv
    # Row 7 bf16 at the shape the bf16 L/14 engine runs it (the large-S half).
    gen.manual_seed(7)
    qkv = torch.randn((256, 257, 3072), generator=gen, device=device).to(torch.bfloat16)
    name = "fused_attention_qkv_bf16_l14"
    _kernel_times({name: (lambda: attention.fused_attention_qkv(qkv, heads=16),
                          lambda: attention.fused_attention_qkv_ref(qkv, None, 16), (qkv,),
                          {"bf16": 4 * 256 * 16 * 257 * 257 * 64})},
                  times, "B=256 S=257 W=1024 (L/14)", card, worst=worst,
                  hold={name: "fused_attention_qkv"})
    times[name].update(_sdpa_times(qkv, 16))
    log(f"[timing] {name} SDPA {times[name]['library_ms']:.3f} ms, transposes "
        f"{times[name]['transpose_ms']:.3f} ms ({card})")
    del qkv
    torch.cuda.empty_cache()
    rng = np.random.default_rng(6)
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        calls = _block_calls(_text_block_inputs(rng, 256, dtype, device))
        _kernel_times({name + suffix: c for name, c in calls.items()}, times,
                      f"B=256 S=77 W=512 {str(dtype)[6:]}", card)
        del calls
        torch.cuda.empty_cache()
    p = _text_block_inputs(rng, 256, torch.bfloat16, device)
    p["qw"] = _quantized(p["bp"])
    _kernel_times(_int8_block_calls(p), times, "B=256 S=77 W=512 int8", card)
    _block_forms_times(p, times, card)
    del p
    torch.cuda.empty_cache()
    _f32_block_times(device, times, card)
    _rank_core_times(device, times, card)
    torch.cuda.empty_cache()
    times.update(train_step_times(params, device, card))
    for fn in _build._COUNTED.values():
        fn.launches = saved[fn.__name__]
    rng = np.random.default_rng(4)
    for label, engine in engines.items():
        times[f"classify_{label}"] = r = _engine_rate(engine, rng)
        log(f"[timing] classify_pixels {label} B=256: {r['images_per_s_b256']:.1f} images/s; "
            f"single image p50 {r['single_image_p50_ms']:.3f} ms ({card})")
    # Per image chunk the int8 engine runs rows 1-2 on the wgmma stage and row
    # 1's core on the tensor-core core, the bf16 engines row 5 (and 10) on
    # the stage and row 5's core on the tensor-core core: no WMMA GEMM, no
    # scalar core.
    for label in ("int8", "bf16", "bf16_pallas_mlp"):
        engine = engines[label]
        px = _pixels(rng, 8, engine.config.image_size)
        d = _device_ms_by_kernel(lambda: engine.classify_pixels(px), ROW_STAGE_NEEDLES)
        REPORT[f"{label}_engine_kernels_per_chunk"] = d
        log(f"[path {label}] one 8-image classify call, device ms by kernel kind: {d}")
        if (d["wgmma_stage"] is None or d["core_mma"] is None or d["wmma_gemm"] is not None
                or d["core_scalar"] is not None):
            raise AssertionError(f"the {label} engine's image chunk launched {d}")
    REPORT["timing"] = times
    return times


# ---------------------------------------------------------------------------
# Phase 11: rows 6, 9 and 17 through their entry points
# ---------------------------------------------------------------------------


def phase_core_ops(device) -> dict:
    """This slice's path: the public entry points of rows 6, 9 and 17 at the
    shapes their users give them, every count set to 0 before and checked
    exactly after: ``flash_attention`` on 256 ViT-B/16 images in fp32 and
    bf16 (2 launches), ``fused_attention_qkv_bwd`` on 256 text rows (S=77,
    causal) and 256 ViT-B/16 images (S=197) in fp32 (the register-tiled
    passes) and bf16 (the tensor-core passes) (4), and ``python -m
    aiic_tpu_torch.probes.mxu_probe 5``'s ``run(5)`` (1 + 5 launches of each
    probe wrapper, the wgmma form; its timings of the WMMA form go through
    the private route and count nothing). The outputs are finite and of
    their shapes, the probe's rates positive."""
    import torch

    from aiic_tpu_torch.ops import attention
    from aiic_tpu_torch.ops._build import launch_counts, reset_launch_counts
    from aiic_tpu_torch.probes import mxu_probe

    gen = torch.Generator(device=device).manual_seed(32)
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (_randn(gen, (256, 197, 12, 64), dtype, device) for _ in range(3))
        outs.append((attention.flash_attention(q, k, v), q.shape))
        del q, k, v
    for dtype in (torch.float32, torch.bfloat16):
        for bsz, seq, heads, causal in ((256, 77, 8, True), (256, 197, 12, False)):
            qkv, g, mask = _row9_inputs(gen, bsz, seq, heads, causal, dtype, device)
            outs.append((attention.fused_attention_qkv_bwd(qkv, mask, g, heads=heads), qkv.shape))
            del qkv, g
    probe = mxu_probe.run(5)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launch_counts()
    want = {"fused_attention": 2, "fused_attention_qkv_bwd": 4, "mxu_bf16": 6, "mxu_i8": 6,
            "mxu_i8_quant": 6}
    log(f"[path core_ops] {seconds:.2f} s; launches {({n: c for n, c in got.items() if c})} "
        f"(expected {want}, 0 for the others)")
    for name, n in got.items():
        if n != want.get(name, 0):
            raise AssertionError(f"core ops path: {name} launched {n} times, expected "
                                 f"{want.get(name, 0)}")
    for out, shape in outs:
        if out.shape != shape or not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"core ops path: an output of shape {tuple(out.shape)} "
                                 f"(want {tuple(shape)}) or not finite")
    for name, r in probe["bodies"].items():
        if not (np.isfinite(r["ms"]) and r["ms"] > 0 and r["tera_ops_per_s"] > 0):
            raise AssertionError(f"probe {name}: {r}")
    del outs
    torch.cuda.empty_cache()
    REPORT["core_ops_path"] = {"seconds": seconds, "launches": got, "expected": want}
    REPORT["mxu_probe"] = probe
    return {name: n for name, n in got.items() if n}


# ---------------------------------------------------------------------------
# Rows 15-16: the kernel-experiment variants (phases 3, 9 and 12)
# ---------------------------------------------------------------------------

# Phase 12's repetitions: one timed stack a variant (the runner's defaults,
# iters 5 and inner 8 or 4, are for `python -m
# aiic_tpu_torch.probes.kernel_experiments N`).
EXPERIMENT_ITERS, EXPERIMENT_INNER = 1, 1


def _variant_layer(device, built):
    """Layer 0 of the seeded ViT-B/16 model of the runner, with seeded biases
    and LN scales (the LN bias stays 0: an all-zero x row is an all-zero LN
    row)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(40)
    lp = dict(built[1][0])
    for key in ("bqkv", "bo", "b1", "b2"):
        lp[key] = (0.1 * torch.randn(lp[key].shape, generator=gen, device=device)).to(lp[key].dtype)
    for key in ("ln1_s", "ln2_s"):
        lp[key] = (1 + 0.1 * torch.randn(lp[key].shape, generator=gen, device=device)).to(
            lp[key].dtype)
    return lp


def _variant_x(gen, bsz, device):
    import torch

    x = torch.randn((bsz, 197, 768), generator=gen, device=device)
    x[0, 0] = 0.0
    return x.to(torch.bfloat16)


def _variant_agreement(out, ref) -> dict:
    """The bf16 bar, with rows that are zero in the plain version (macbf16
    maps the zero x row to zero) held to equality instead of a cosine."""
    import torch

    zero = ~ref.reshape(-1, ref.shape[-1]).bool().any(dim=-1)
    o, r = out.reshape(-1, out.shape[-1]), ref.reshape(-1, ref.shape[-1])
    a = _agreement(o[~zero], r[~zero])
    a["zero_rows_equal"] = bool(torch.equal(o[zero], r[zero]))
    a["ok"] = a["ok"] and a["zero_rows_equal"]
    return a


def _variant_check(wrapper: str, v: str, x, lp, out, ref, form: str = "wgmma") -> dict:
    """The bars of rows 15-16: the bf16 bar, maconly exact; form 0's 16d
    schedules bit for bit row 1's form 0 (the same stage and core arithmetic
    without the 1e-38 guard) and its gelu2 bit for bit row 2's form 0."""
    import torch

    from aiic_tpu_torch.ops import quant

    a = _variant_agreement(out, ref)
    if v == "maconly":
        a["bit_identical"] = bool(torch.equal(out, ref))
        a["ok"] = a["ok"] and a["bit_identical"]
    if wrapper == "attn_var5" and form == "wgmma":
        row1 = quant._int8_ln_qkv_attention_cuda(
            x, lp["ln1_s"], lp["ln1_b"], lp["wqkv_q"], lp["sqkv"], lp["bqkv"],
            lp["wo"], lp["bo"], None, lp["heads"], 1e-5, "wgmma")
        a["bit_identical_to_row1"] = bool(torch.equal(out, row1))
        a["ok"] = a["ok"] and a["bit_identical_to_row1"]
    if v == "gelu2" and form == "wgmma":
        row2 = quant._int8_ln_mlp_cuda(x, lp["ln2_s"], lp["ln2_b"], lp["w1_q"], lp["s1"],
                                       lp["b1"], lp["w2_q"], lp["s2"], lp["b2"], 1e-5)
        a["bit_identical_to_row2"] = bool(torch.equal(out, row2))
        a["ok"] = a["ok"] and a["bit_identical_to_row2"]
    return a


_VARIANT_BITS = ("bit_identical", "bit_identical_to_row1", "bit_identical_to_row2")


def _hold_variant(results: list, wrapper: str, v: str, x, lp, out, ref,
                  form: str = "wgmma") -> dict:
    a = _variant_check(wrapper, v, x, lp, out, ref, form)
    bsz = x.shape[0]
    a.update(kernel=wrapper, variant=v, form=form, case=f"ViT-B/16 B={bsz}")
    results.append(a)
    log(f"[kernels] {wrapper:16s} {v:9s} {form:5s} B={bsz:<4d} max_abs_err={a['max_abs_err']:.6g} "
        f"within_2ulp={a['within_2ulp']:.6f} min_row_cos={a['min_row_cos']:.8f}"
        + "".join(f" {k}={a[k]}" for k in _VARIANT_BITS if k in a))
    if not a["ok"]:
        raise AssertionError(f"{wrapper}[{v}] ({form}) disagrees with its plain version at "
                             f"B={bsz}: {a}")
    return a


def _variant_kernel(wrapper: str):
    from aiic_tpu_torch.probes import variants

    return variants._mlp_cuda if wrapper.startswith("mlp") else variants._attn_cuda


def phase_variant_kernels(device, built) -> dict:
    """Phase 3 for rows 15-16: every variant of each wrapper (form 0, the
    route) against its plain version at the ViT-B/16 shapes, B = 2 and 64
    (and 1 for the two kernel_experiments.py functions; and 1024, experiment
    7's batch, for the three int8-core variants), x with an all-zero row;
    counts at 0 before and one launch after each call (``_variant_check``'s
    bars); form 1 (the WMMA design, uncounted) beside at the smallest batch."""
    import torch

    from aiic_tpu_torch.probes import variants

    lp = _variant_layer(device, built)
    gen = torch.Generator(device=device).manual_seed(41)
    worst, results = {}, []
    for wrapper, names in variants.WRAPPER_VARIANTS.items():
        batches = {"int8_attn_nomax": (1, 2, 64), "mlp_var": (1, 2, 64),
                   "attn_var7": (2, 64, 1024)}.get(wrapper, (2, 64))
        for bsz in batches:
            x = _variant_x(gen, bsz, device)
            for v in names:
                fn = variants.WRAPPERS[wrapper]
                out = _one_launch(wrapper, lambda: fn(x, lp, v))
                ref = variants.PLAIN[wrapper](x, lp, v)
                a = _hold_variant(results, wrapper, v, x, lp, out, ref)
                worst[wrapper] = max(worst.get(wrapper, 0.0), a["max_abs_err"])
                if bsz == batches[0]:
                    out = _variant_kernel(wrapper)(wrapper, x, lp, v, form="wmma")
                    _hold_variant(results, wrapper, v, x, lp, out, ref, "wmma")
                del out, ref
            del x
            torch.cuda.empty_cache()
    REPORT["variant_kernel_checks"] = results
    return worst


# Device ms by stage of the variants' two forms; form 0 must launch the
# stage (and the variant core where the variant has a core) and none of the
# first design's kernels (common.cuh's WMMA gemm_kernel and scalar cores).
VARIANT_STAGE_NEEDLES = {"row_pass": "rowquant", "ln_pass": "ln_rows_kernel",
                         "fill": "fill_int8_kernel", "wgmma_stage": "wgmma_stage_kernel",
                         "var_core_mma": "var_core_mma_kernel", "wmma_gemm": "gemm_kernel<",
                         "var_core_scalar": "var_core_kernel<",
                         "core_scalar": "attn_core_kernel<"}


def _variant_form0_launches(name: str, has_core: bool, d: dict) -> None:
    first = [k for k in ("wmma_gemm", "var_core_scalar", "core_scalar") if d[k] is not None]
    if first or d["wgmma_stage"] is None or (d["var_core_mma"] is None) == has_core:
        raise AssertionError(f"{name} form 0 launched {d}: it must run the stage "
                             f"{'and the variant core ' if has_core else ''}and none of {first}")


def phase_variant_timing(device, card: str, built, worst: dict) -> dict:
    """Phase 9 for rows 15-16: one launch of each variant's form 0 at B=256
    beside its plain version (plain, kernel, kernel, plain), with its bound
    from the tensors the variant reads and its products' operations; form 0
    again and right after it form 1 (the WMMA design) on the same inputs;
    both forms' device ms by stage (``torch.profiler``, traces checked whole:
    form 0 launches the stage and the variant core, no WMMA GEMM or scalar
    core); then the timed launch's output held against the plain version
    (``_variant_check``'s bars, one launch counted) and form 1's too. The
    kernels line carries each wrapper's first variant; the report has them
    all. Launch counts are put back."""
    import torch

    from aiic_tpu_torch.ops import _build
    from aiic_tpu_torch.probes import variants

    saved = _build.launch_counts()
    lp = _variant_layer(device, built)
    x = _variant_x(torch.Generator(device=device).manual_seed(42), 256, device)
    times, per_variant, checks = {}, {}, []
    for wrapper, names in variants.WRAPPER_VARIANTS.items():
        for v in names:
            fn, plain = variants.WRAPPERS[wrapper], variants.PLAIN[wrapper]
            wmma = lambda: _variant_kernel(wrapper)(wrapper, x, lp, v, form="wmma")  # noqa: E731
            ops = variants.ops(wrapper, v, 256, 197, 768, 3072)
            inputs = [x] + [lp[k] for k in variants.reads(wrapper, v)]
            t: dict = {}
            _kernel_times({wrapper: (lambda: fn(x, lp, v), lambda: plain(x, lp, v), inputs, ops)},
                          t, f"[{v}] B=256 S=197 W=768", card)
            t = t[wrapper]
            t["ms_beside_wmma"] = min(_time_ms(lambda: fn(x, lp, v), 10) for _ in range(2))
            t["wmma_ms"] = min(_time_ms(wmma, 10) for _ in range(2))
            t["device_ms_by_stage"] = _device_ms_by_kernel(lambda: fn(x, lp, v),
                                                           VARIANT_STAGE_NEEDLES)
            t["wmma_device_ms_by_stage"] = _device_ms_by_kernel(wmma, VARIANT_STAGE_NEEDLES)
            spec = (variants.MLP_VARIANTS if wrapper.startswith("mlp")
                    else variants.ATTN_VARIANTS)[v]
            _variant_form0_launches(f"{wrapper}[{v}]", getattr(spec, "core", None) is not None,
                                    t["device_ms_by_stage"])
            log(f"[timing] {wrapper}[{v}] form 0 {t['ms']:.3f} ms ({t['ms_beside_wmma']:.3f} "
                f"right before form 1), form 1 (WMMA) {t['wmma_ms']:.3f} ms, plain "
                f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms; device ms by stage "
                f"{t['device_ms_by_stage']}, form 1 {t['wmma_device_ms_by_stage']} ({card})")
            ref = plain(x, lp, v)
            out = _one_launch(wrapper, lambda: fn(x, lp, v))
            a = _hold_variant(checks, wrapper, v, x, lp, out, ref)
            del out
            _hold_variant(checks, wrapper, v, x, lp, wmma(), ref, "wmma")
            per_variant[f"{wrapper}[{v}]"] = dict(t, max_abs_err=a["max_abs_err"])
            worst[wrapper] = max(worst[wrapper], a["max_abs_err"])
            times.setdefault(wrapper, dict(t, variant=v))
            del ref
            torch.cuda.empty_cache()
    for fn in _build._COUNTED.values():
        fn.launches = saved[fn.__name__]
    REPORT.setdefault("timing", {}).update(times)
    REPORT["variant_timing"] = per_variant
    REPORT["variant_kernel_checks"] += checks
    return times


def phase_experiments(device, built) -> dict:
    """Phase 12, rows 15-16's path: ``kernel_experiments.run_experiment`` for
    experiments 1-5 and 7 (the entry point of ``python -m
    aiic_tpu_torch.probes.kernel_experiments N``) at the tools' batches, every
    count set to 0 before and checked exactly after: 12 launches of the
    variant's wrapper for each 12-layer stack the runner reports, 12 of rows
    1 or 2 for each prod stack, and 11 of each for every classify call (the
    last block runs on the CLS row), with the GEMM stage's two launches
    inside each of theirs. Every stack's time is finite and each
    REAL candidate's cosine against prod is reported."""
    import torch

    from aiic_tpu_torch.ops._build import launch_counts, reset_launch_counts
    from aiic_tpu_torch.probes import kernel_experiments as ke

    reset_launch_counts()
    t0 = time.perf_counter()
    want: dict = {}
    out = {}
    layers = len(built[1])
    for exp, e in ke.EXPERIMENTS.items():
        res = out[exp] = ke.run_experiment(exp, EXPERIMENT_ITERS, EXPERIMENT_INNER, device=device,
                                           built=built)
        for v in e["variants"]:
            if v in ("prod", "prod_attn", "prod_mlp"):
                half = ("mlp" if v == "prod_mlp" or e.get("wrapper", "").startswith("mlp")
                        else "attn")
                name = "int8_ln_mlp" if half == "mlp" else "int8_ln_qkv_attention"
            else:
                name = e.get("wrapper") or ke._EXP1[v][1]
            want[name] = want.get(name, 0) + layers * res[v]["stacks"]
            want["gemm_stage"] = (want.get("gemm_stage", 0)
                                  + STAGE_LAUNCHES.get(name, 0) * layers * res[v]["stacks"])
            if not np.isfinite(res[v]["ms"]) or res[v]["ms"] <= 0:
                raise AssertionError(f"experiment {exp} [{v}]: {res[v]}")
        if res.get("prod_check_stacks"):
            name = "int8_ln_mlp" if e["wrapper"].startswith("mlp") else "int8_ln_qkv_attention"
            want[name] += layers * res["prod_check_stacks"]
            want["gemm_stage"] = (want.get("gemm_stage", 0)
                                  + STAGE_LAUNCHES[name] * layers * res["prod_check_stacks"])
        for r in res.get("classify", {}).values():
            for name in ("int8_ln_qkv_attention", "int8_ln_mlp"):
                want[name] += (layers - 1) * r["calls"]
                want["gemm_stage"] = (want.get("gemm_stage", 0)
                                      + STAGE_LAUNCHES[name] * (layers - 1) * r["calls"])
            if not r["finite"]:
                raise AssertionError(f"experiment 1's classify program gave a non-finite sum: {r}")
        for v in e["real"]:
            if not np.isfinite(res[v].get("cosine", np.nan)):
                raise AssertionError(f"experiment {exp} [{v}]: no finite cosine against prod")
        log(f"[path experiments] experiment {exp}: prod - variant, ms a 12-layer stack at "
            f"B={e['batch']} (rows 1-2's time by pass): {res['attribution']}")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launch_counts()
    log(f"[path experiments] {seconds:.2f} s; launches {({n: c for n, c in got.items() if c})} "
        f"(expected {want}, 0 for the others)")
    for name, n in got.items():
        if n != want.get(name, 0):
            raise AssertionError(f"experiments path: {name} launched {n} times, expected "
                                 f"{want.get(name, 0)}")
    REPORT["experiments_path"] = {"seconds": seconds, "launches": got, "expected": want,
                                  "results": out}
    return {name: n for name, n in got.items() if n}


# ---------------------------------------------------------------------------
# Phase 13: the serving surface (the worker's REST app, the apartment drain,
# the worker CLI as a process) on rows 5 and 1-2
# ---------------------------------------------------------------------------

# The two worker configurations served: label, configuration of CONFIGS (its
# kernels), the worker CLI's flags beyond its defaults.
REST_CONFIGS = (("bf16", "bf16", []),
                ("int8", "int8", ["--dtype", "bfloat16", "--quantize", "--wire-format", "patch"]))
# A REST answer against the same engine's classify_pixels on the same pixels
# (another batch, so another cuBLAS product order for the bf16 MLP):
# confidences and attribute scores within REST_TOL; verdicts, categories and
# top-5 names equal wherever the engine's own values are not within REST_TOL
# of a tie.
REST_TOL = 2e-2
REST_SINGLES = 20


def _rest_images(rng, n: int, lo: int = 160, hi: int = 480) -> list:
    """n synthetic JPEGs and PNGs of assorted sizes in [lo, hi) (every third a
    PNG): in turn a flat colour, a two-colour gradient, a checkerboard and
    noise, so that the seeded weights judge some interior and the answers
    carry their attribute top-5 too."""
    import io

    from PIL import Image

    out = []
    for i in range(n):
        h, w = int(rng.integers(lo, hi)), int(rng.integers(lo, hi))
        yy, xx = np.mgrid[0:h, 0:w]
        a, b = rng.integers(0, 256, 3), rng.integers(0, 256, 3)
        if i % 4 == 0:
            img = np.broadcast_to(a, (h, w, 3))
        elif i % 4 == 1:
            t = ((xx / w) if rng.random() < 0.5 else (yy / h))[..., None]
            img = a * (1 - t) + b * t
        elif i % 4 == 2:
            m = ((xx * int(rng.integers(2, 12)) // w + yy * int(rng.integers(2, 12)) // h) % 2)
            img = np.where(m[..., None] == 1, a, b)
        else:
            img = rng.integers(0, 256, (h, w, 3))
        buf = io.BytesIO()
        pixels = np.asarray(img, dtype=np.float64).clip(0, 255).astype(np.uint8)
        Image.fromarray(pixels).save(buf, format="PNG" if i % 3 == 2 else "JPEG")
        out.append(buf.getvalue())
    return out


def _http(port: int, method: str, path: str, body: bytes = None):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _rest_disagreement(got: dict, res: dict, row: int, engine) -> list:
    """Where a REST answer departs from the engine's classify results for the
    same pixels beyond REST_TOL (ties within REST_TOL excepted)."""
    bad = []
    margin = min(abs(float(res["interior_mass"][row] - res["non_interior_mass"][row])),
                 abs(float(res["top_conf"][row]) - 0.3))
    want = engine._result(res, row, True, 0.3)
    if abs(got["interior_confidence"] - want["interior_confidence"]) > REST_TOL:
        bad.append(("interior_confidence", got["interior_confidence"],
                    want["interior_confidence"]))
    if margin > REST_TOL and got["is_interior"] != want["is_interior"]:
        bad.append(("is_interior", got["is_interior"], want["is_interior"]))
    if not (got["is_interior"] and want["is_interior"]):
        if margin > REST_TOL and got["detected_category"] != want["detected_category"] \
                and float(res["top_conf"][row]) > 0.5 + REST_TOL:
            bad.append(("detected_category", got["detected_category"], want["detected_category"]))
        return bad
    for cat, top in want["analysis"].items():
        vals = [v for _, v in top]
        gvals = [v for _, v in got["analysis"].get(cat, [])]
        if len(gvals) != len(vals) or np.abs(np.subtract(gvals, vals)).max() > REST_TOL:
            bad.append((cat, got["analysis"].get(cat), top))
            continue
        for k, (name, v) in enumerate(top):
            apart = all(abs(v - u) > REST_TOL for j, u in enumerate(vals) if j != k)
            if apart and got["analysis"][cat][k][0] != name:
                bad.append((cat, got["analysis"][cat], top))
                break
    return bad


def _hold_rest(label: str, answers: list, blobs: list, engine, wire_patch: int) -> dict:
    """Each answer against the engine's classify_pixels on the pixels the
    app decodes from its blob (one call for all of them)."""
    from concurrent.futures import ThreadPoolExecutor

    from aiic_tpu_torch.data.native_loader import preprocess_any_batch

    # one blob a task, as the app decodes them (the Python fallback's numpy
    # resize runs outside the interpreter lock, so the pool overlaps them)
    with ThreadPoolExecutor(8) as pool:
        decoded = list(pool.map(lambda b: preprocess_any_batch(
            [b], engine.config.image_size, patch=wire_patch), blobs))
    px = np.concatenate([d[0] for d in decoded])
    ok = np.concatenate([d[1] for d in decoded])
    if not ok.all():
        raise AssertionError(f"[rest {label}] a synthetic image did not decode")
    res = engine.classify_pixels(px)
    worst, bad = 0.0, []
    for i, got in enumerate(answers):
        if set(got) != {"is_interior", "interior_confidence", "detected_category", "analysis",
                        "reason"}:
            raise AssertionError(f"[rest {label}] malformed answer {got}")
        worst = max(worst, abs(got["interior_confidence"] - float(res["interior_mass"][i])))
        bad += [(i, b) for b in _rest_disagreement(got, res, i, engine)]
    if bad:
        raise AssertionError(f"[rest {label}] answers depart from classify_pixels: {bad[:5]}")
    return {"n": len(answers), "max_confidence_diff": worst,
            "interior": int(sum(a["is_interior"] for a in answers))}


def _batch_launches(opts: dict, config, sizes: dict) -> dict:
    """Launches the classify program makes for batches of these sizes
    ({size: count}), one chunk each (sizes up to the worker's max_batch):
    the image tower's blocks at the batch's bucket, the CLS-row block
    aside."""
    from aiic_tpu_torch.utils.batching import bucket_size

    v = config.vision
    want: dict = {}
    for size, count in sizes.items():
        for name in _block_kernels(opts, config.vision_seq_len, v.width, v.heads,
                                   bucket_size(size, 1 << 20)):
            want[name] = want.get(name, 0) + (v.layers - 1) * count
    return want


def _launch_delta(before: dict, after: dict) -> dict:
    return {n: after[n] - before.get(n, 0) for n in after if after[n] - before.get(n, 0)}


def _check_launches(label: str, stage: str, got: dict, want: dict) -> dict:
    want = {n: c for n, c in want.items() if c}
    log(f"[rest {label}] {stage}: launches {got} (expected {want})")
    if got != want:
        raise AssertionError(f"[rest {label}] {stage}: launched {got}, expected {want}")
    return got


def _batch_sizes(snap: dict) -> dict:
    pre = "batches_of_size_"
    return {int(k[len(pre):-len("_total")]): int(v) for k, v in snap.items() if k.startswith(pre)}


def _wait_images(metrics, before: dict, n: int) -> dict:
    """The metrics snapshot once the batcher has resolved n more images."""
    deadline = time.monotonic() + 60
    while True:
        snap = metrics.snapshot()
        if snap.get("images_total", 0) - before.get("images_total", 0) >= n:
            return snap
        if time.monotonic() > deadline:
            raise AssertionError(f"the batcher resolved {snap.get('images_total', 0)} images, "
                                 f"expected {before.get('images_total', 0) + n}")
        time.sleep(0.01)


def _serve_config(label: str, conf: str, flags: list, root: str, card: str, params) -> tuple:
    """Step 1 for one configuration: the app as ``cli.worker --serve`` builds
    it, its launches counted stage by stage, its answers held against the
    engine and the CPU."""
    import base64
    import threading

    import torch

    from aiic_tpu_torch.cli import worker as cli_worker
    from aiic_tpu_torch.cli.common import EngineArgs
    from aiic_tpu_torch.data.native_loader import native_available
    from aiic_tpu_torch.ops._build import launch_counts, reset_launch_counts
    from aiic_tpu_torch.serve.app import build_serving_app
    from aiic_tpu_torch.serve.db import InMemoryDB
    from aiic_tpu_torch.serve.metrics import GLOBAL_METRICS
    from aiic_tpu_torch.utils.profiling import StageTimer

    opts = CONFIGS[conf]
    t0 = time.perf_counter()
    decoder = "native" if native_available() else "Python fallback"  # built before any request
    log(f"[rest {label}] image decoder: {decoder} ({time.perf_counter() - t0:.2f} s)")
    ds = os.path.join(root, "dataset.json")
    args = cli_worker.build_parser().parse_args(
        ["--serve", "--port", "0", "--weights", os.path.join(root, "weights.npz"),
         "--dataset-json", ds, "--text-cache", os.path.join(root, f"text_{label}.npz")] + flags)
    reset_launch_counts()
    t0 = time.perf_counter()
    engine = EngineArgs.from_args(args).build_analyzer(log=log)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    at_build = launch_counts()
    path: dict = {}  # the REST path's launches, stage by stage (not the checks against it)
    n_prompts = engine.det_text.shape[0] + int(engine.cat_mask.sum())
    want_build, _ = _expected_launches(opts, engine.config, n_prompts, [])
    _add(path, _check_launches(label, f"engine build ({build_s:.2f} s, {n_prompts} prompts)",
                               {n: c for n, c in at_build.items() if c}, want_build))
    server, batcher, warmed = build_serving_app(
        engine, db=InMemoryDB(), confidence=args.confidence, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        request_timeout=args.request_timeout, max_queue=args.max_queue or None,
        fast_decode=args.fast_decode, wire_format=args.wire_format,
        pipeline_depth=args.pipeline_depth, max_batch_items=args.max_batch_items, log=log)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    wire_patch = engine.config.patch_size if args.wire_format == "patch" else 0
    out: dict = {"build_s": build_s, "launches_at_build": at_build}
    try:
        t0 = time.perf_counter()
        if not warmed.wait(300):
            raise AssertionError(f"[rest {label}] warmup did not finish in 300 s")
        out["warmup_s"] = time.perf_counter() - t0
        before = launch_counts()
        buckets = [b for b in (1, 2, 4, 8, 16, 32) if b < args.max_batch] + [args.max_batch]
        _add(path, _check_launches(label, f"warmup of buckets {buckets} ({out['warmup_s']:.2f} s)",
                                   _launch_delta(at_build, before),
                                   _batch_launches(opts, engine.config, {b: 1 for b in buckets})))
        status, ready = _http(port, "GET", "/ready")
        if status != 200 or ready.get("ready") is not True:
            raise AssertionError(f"[rest {label}] /ready answered {status} {ready}")
        # the stage timings of /metrics from here on are this configuration's
        # requests alone (the process-wide timer also holds every earlier
        # phase's classify calls)
        GLOBAL_METRICS.stages = StageTimer()

        rng = np.random.default_rng(13)
        singles = _rest_images(rng, REST_SINGLES)
        snap0 = GLOBAL_METRICS.snapshot()
        lat, answers = [], []
        t_all = time.perf_counter()
        for blob in singles:
            t0 = time.perf_counter()
            status, ans = _http(port, "POST", "/analyze", blob)
            lat.append(1e3 * (time.perf_counter() - t0))
            if status != 200:
                raise AssertionError(f"[rest {label}] POST /analyze answered {status} {ans}")
            answers.append(ans)
        t_all = time.perf_counter() - t_all
        snap1 = _wait_images(GLOBAL_METRICS, snap0, REST_SINGLES)
        after = launch_counts()
        _add(path, _check_launches(label, f"{REST_SINGLES} sequential POST /analyze",
                                   _launch_delta(before, after),
                                   _batch_launches(opts, engine.config, {1: REST_SINGLES})))
        out["singles"] = _hold_rest(label, answers, singles, engine, wire_patch)
        out["singles"].update(
            p50_ms=float(np.percentile(lat, 50)), p90_ms=float(np.percentile(lat, 90)),
            requests_per_s=REST_SINGLES / t_all)
        status, err = _http(port, "POST", "/analyze", b"not an image")
        if status != 200 or err != {"error": "could not decode image"}:
            raise AssertionError(f"[rest {label}] an undecodable image got {status} {err}")

        batch = _rest_images(rng, 64)
        before = launch_counts()
        t0 = time.perf_counter()
        status, body = _http(port, "POST", "/analyze-batch", json.dumps(
            {"images_b64": [base64.b64encode(b).decode() for b in batch]}).encode())
        batch_s = time.perf_counter() - t0
        if status != 200 or len(body.get("results", [])) != 64:
            raise AssertionError(f"[rest {label}] POST /analyze-batch answered {status}")
        snap2 = _wait_images(GLOBAL_METRICS, snap1, 64)
        sizes = {s: c - _batch_sizes(snap1).get(s, 0) for s, c in _batch_sizes(snap2).items()}
        sizes = {s: c for s, c in sizes.items() if c}
        _add(path, _check_launches(label, f"POST /analyze-batch of 64 in {batch_s:.3f} s, "
                                          f"batches {sizes}",
                                   _launch_delta(before, launch_counts()),
                                   _batch_launches(opts, engine.config, sizes)))
        out["batch"] = {**_hold_rest(label, body["results"], batch, engine, wire_patch),
                        "seconds": batch_s, "batch_sizes": sizes}

        burst = _rest_images(rng, 64)
        got: list = [None] * 64

        def client(k):
            for i in range(k, 64, 16):
                got[i] = _http(port, "POST", "/analyze", burst[i])

        before = launch_counts()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(16)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        burst_s = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or any(g is None or g[0] != 200 for g in got):
            raise AssertionError(f"[rest {label}] the burst did not complete: "
                                 f"{[g[0] if g else None for g in got]}")
        snap3 = _wait_images(GLOBAL_METRICS, snap2, 64)
        status, m = _http(port, "GET", "/metrics")
        sizes = {s: c - _batch_sizes(snap2).get(s, 0) for s, c in _batch_sizes(m).items()}
        sizes = {s: c for s, c in sizes.items() if c}
        if m["images_total"] != snap3["images_total"]:
            raise AssertionError(f"[rest {label}] /metrics and the batcher disagree")
        _add(path, _check_launches(label, f"burst of 64 from 16 clients in {burst_s:.3f} s, "
                                          f"batches {sizes} (11 launches a batch)",
                                   _launch_delta(before, launch_counts()),
                                   _batch_launches(opts, engine.config, sizes)))
        out["burst"] = {**_hold_rest(label, [g[1] for g in got], burst, engine, wire_patch),
                        "seconds": burst_s, "images_per_s": 64 / burst_s, "batch_sizes": sizes}

        stages = {k: v for k, v in m.items() if k.startswith("stage_") and k.endswith("_p50_ms")}
        for name in ("dispatch", "fetch", "serve_decode"):
            if f"stage_{name}_p50_ms" not in m:
                raise AssertionError(f"[rest {label}] /metrics lacks the {name} stage: {sorted(m)}")
        for route in ("/health", "/dead-letters"):
            status, body = _http(port, "GET", route)
            if status != 200:
                raise AssertionError(f"[rest {label}] GET {route} answered {status}")
        out.update(stage_p50_ms=stages, decoder=decoder, launches=path)
        s = out["singles"]
        log(f"[rest {label}] ({card}) single-image POST /analyze p50 {s['p50_ms']:.3f} ms, p90 "
            f"{s['p90_ms']:.3f} ms, {s['requests_per_s']:.1f} requests/s; burst of 64 from 16 "
            f"clients {out['burst']['images_per_s']:.1f} images/s in batches {sizes}; "
            f"/analyze-batch of 64 {64 / batch_s:.1f} images/s in batches "
            f"{out['batch']['batch_sizes']}; decoder {out['decoder']}; stage p50 ms {stages}; "
            f"answers against classify_pixels: max confidence diff "
            f"{max(out[k]['max_confidence_diff'] for k in ('singles', 'batch', 'burst')):.2e}, "
            f"{sum(out[k]['interior'] for k in ('singles', 'batch', 'burst'))} of 148 interior "
            f"(their top-5 held too)")
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    phase_cpu_compare(conf, engine, params, tag="_rest")
    REPORT.setdefault("rest", {})[label] = out
    return engine, path


def _drain(engine, root: str) -> dict:
    """Step 2: process_apartments_pipeline on an InMemoryDB of two apartments
    of 4 local images each and one unreadable path."""
    from aiic_tpu_torch.ops._build import launch_counts, reset_launch_counts
    from aiic_tpu_torch.serve.db import InMemoryDB
    from aiic_tpu_torch.serve.worker import process_apartments_pipeline

    rng = np.random.default_rng(14)
    db = InMemoryDB()
    for a in ("apt1", "apt2"):
        db.insert_apartment(a, title=f"{a} (synthetic)")
    for i, blob in enumerate(_rest_images(rng, 8)):
        path = os.path.join(root, f"drain{i}.{'png' if i % 3 == 2 else 'jpg'}")
        with open(path, "wb") as f:
            f.write(blob)
        db.insert_image(f"img{i}", "apt1" if i < 4 else "apt2", path)
    db.insert_image("img_bad", "apt1", os.path.join(root, "unreadable.jpg"))
    export = os.path.join(root, "analysis_export.json")
    reset_launch_counts()
    t0 = time.perf_counter()
    out = process_apartments_pipeline(db=db, analyzer=engine, batch_size=8, export_file=export,
                                      log=log)
    seconds = time.perf_counter() - t0
    got = {n: c for n, c in launch_counts().items() if c}
    _check_launches("bf16", f"apartment drain ({seconds:.2f} s)", got,
                    _batch_launches(CONFIGS["bf16"], engine.config, {4: 2}))
    statuses = {k: im["analysis_status"] for k, im in db.images.items()}
    bad = db.images["img_bad"]
    if out != export or any(s not in ("completed", "not_interior")
                            for k, s in statuses.items() if k != "img_bad"):
        raise AssertionError(f"[rest drain] statuses {statuses}")
    if (bad["analysis_status"], bad.get("attempts"), bad.get("last_error")) != (
            "pending", 1, "load failed"):
        raise AssertionError(f"[rest drain] the unreadable image's record {bad}")
    with open(export, encoding="utf-8") as f:
        exported = json.load(f)
    if sorted(r["apartment_id"] for r in exported) != ["apt1", "apt2"] or any(
            r["total_images"] != (5 if r["apartment_id"] == "apt1" else 4) for r in exported):
        raise AssertionError(f"[rest drain] export {exported}")
    held = [(r["apartment_id"], r["overall_style"]["style"], r["room_distribution"])
            for r in exported]
    log(f"[rest drain] statuses {statuses}; the unreadable image's attempt recorded; export "
        f"holds {held}")
    REPORT.setdefault("rest", {})["drain"] = {"seconds": seconds, "launches": got,
                                             "statuses": statuses}
    return got


def _worker_process(root: str) -> dict:
    """Step 3: ``python -m aiic_tpu_torch.cli.worker --serve`` with the
    default flags (step 1's weights and its bf16 text cache), ready within a
    bound, one
    POST /analyze and GET /metrics, then SIGTERM and exit code 0."""
    import signal
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "aiic_tpu_torch.cli.worker", "--serve", "--port", str(port),
           "--weights", os.path.join(root, "weights.npz"),
           "--dataset-json", os.path.join(root, "dataset.json"),
           "--text-cache", os.path.join(root, "text_bf16.npz")]
    env = {**os.environ, "PYTHONPATH": HERE + os.pathsep + os.environ.get("PYTHONPATH", "")}
    logf = open(os.path.join(root, "worker.log"), "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=logf, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 300
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"the worker exited with {proc.returncode} before /ready")
            try:
                status, _ = _http(port, "GET", "/ready")
                if status == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise AssertionError("the worker was not ready within 300 s")
            time.sleep(0.5)
        ready_s = time.perf_counter() - t0
        status, ans = _http(port, "POST", "/analyze", _rest_images(np.random.default_rng(15), 1)[0])
        if status != 200 or "is_interior" not in ans:
            raise AssertionError(f"the worker's POST /analyze answered {status} {ans}")
        status, m = _http(port, "GET", "/metrics")
        if status != 200 or m.get("images_total", 0) < 1 or "stage_dispatch_p50_ms" not in m:
            raise AssertionError(f"the worker's /metrics answered {status} {m}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        logf.close()
    with open(os.path.join(root, "worker.log")) as f:
        tail = f.read()[-2000:]
    log(f"[rest worker] python -m aiic_tpu_torch.cli.worker --serve: ready in {ready_s:.1f} s, "
        f"one POST /analyze and GET /metrics answered, exit code {rc} on SIGTERM")
    if rc != 0:
        raise AssertionError(f"the worker exited with {rc} on SIGTERM:\n{tail}")
    REPORT.setdefault("rest", {})["worker_process"] = {"ready_s": ready_s, "rc": rc}
    return {"ready_s": ready_s}


def phase_rest(device, card: str) -> dict:
    """Phase 13: the worker's REST app in both worker configurations, the
    apartment drain, the worker CLI as a process. Returns the launches."""
    import torch

    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.models.init import init_clip_params, save_clip_weights

    t0 = time.perf_counter()
    launches: dict = {}
    with tempfile.TemporaryDirectory() as root:
        with open(os.path.join(root, "dataset.json"), "w", encoding="utf-8") as f:
            json.dump({"training_data": TRAINING_DATA}, f, ensure_ascii=False)
        # One seeded init made with the CPU's generator, so that the weights
        # are the same on any machine, saved as the npz that --weights loads.
        # (The card's generator with seed 0 puts every synthetic image in
        # one non-interior category; these weights judge some of them
        # interior, so the answers carry their top-5 too.)
        params = init_clip_params(VIT_B_16, torch.Generator().manual_seed(0), device="cpu")
        save_clip_weights(params, os.path.join(root, "weights.npz"))
        engines = {}
        for label, conf, flags in REST_CONFIGS:
            engines[label], got = _serve_config(label, conf, flags, root, card, params)
            _add(launches, got)
        del engines["int8"], params
        _add(launches, _drain(engines["bf16"], root))
        del engines
        torch.cuda.empty_cache()
        _worker_process(root)
    REPORT.setdefault("rest", {})["seconds"] = time.perf_counter() - t0
    log(f"[rest] phase 13 took {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 14: dataset evaluation (attribute-F1, the eval_f1 and parity_report
# twins, the oracle check), clip_forward and the image tower's LoRA
# ---------------------------------------------------------------------------

EVAL_IMAGES = 32
EVAL_CONFIGS = ("int8", "bf16")  # the int8 worker configuration and the worker default
# Every attribute score on the card within SCORE_TOL of the CPU plain path's,
# and a card-vs-CPU decision that differs a swap of two attributes whose CPU
# scores differ by less than SWAP_TOL. The attribute softmax runs at a 100x
# temperature, so the text and image features' card-vs-CPU cosines (0.9997-
# 0.99998, phase 5) move a score by a few hundredths: 3.6e-2 (int8) and 3.2e-2
# (bf16) at most here, on an H100; two attributes closer than that can swap.
SCORE_TOL = 5e-2
SWAP_TOL = SCORE_TOL
PARITY_COS_MIN = 0.999  # BASELINE.md's logit agreement bar
EVAL_F1_LIMIT = 16
# The engine tools/torch_eval_f1.py builds: the JAX tool's options.
EVAL_F1_OPTS = dict(dtype="float32", quantize=False, wire_format="hwc", attn_impl="auto")
# tools/torch_parity_report.py needs transformers. The card's machine has it,
# so phase 14 runs the twin as a process in fp32 and in the serving
# configuration, each on the first PARITY_TWIN_LIMIT generated JPEGs.
PARITY_TWIN_FLAGS = {"parity_fp32": ["--attn-impl", "pallas"],
                     "parity_serving": ["--dtype", "bfloat16", "--quantize", "--wire", "patch",
                                        "--attn-impl", "pallas"]}
PARITY_TWIN_LIMIT = 8
CLIP_FORWARD_IMAGES = 8


def _eval_dataset(root: str) -> list:
    """EVAL_IMAGES synthetic 224-288 px JPEGs and PNGs under
    ``root/dataset_images`` and their labelled items, written as
    ``root/interior_dataset.json``: the first two items carry TRAINING_DATA's
    labels (so that the vocabulary, 52 prompts, is the engines' own), the
    others labels drawn from that vocabulary by seed."""
    from aiic_tpu_torch.data.dataset import extract_all_categories

    rng = np.random.default_rng(21)
    vocab = extract_all_categories(TRAINING_DATA)
    os.makedirs(os.path.join(root, "dataset_images"))
    items = []
    for i, blob in enumerate(_rest_images(rng, EVAL_IMAGES, 224, 289)):
        name = f"dataset_images/eval{i:02d}.{'png' if i % 3 == 2 else 'jpg'}"
        with open(os.path.join(root, name), "wb") as f:
            f.write(blob)
        if i < len(TRAINING_DATA):
            items.append({**TRAINING_DATA[i], "image_path": name})
            continue

        def pick(key, k):
            return [str(v) for v in rng.choice(vocab[key], k, replace=False)]

        items.append({"image_path": name, "style": pick("styles", 1)[0],
                      "characteristics": pick("characteristics", int(rng.integers(1, 4))),
                      "materials": pick("materials", int(rng.integers(0, 3))),
                      "colors": pick("colors", int(rng.integers(1, 4))),
                      "room_type": pick("room_types", 1)[0]})
    with open(os.path.join(root, "interior_dataset.json"), "w", encoding="utf-8") as f:
        json.dump({"training_data": items}, f, ensure_ascii=False)
    return items


class _Recorded:
    """An analyzer that keeps the per-image results ``attribute_f1`` asked
    for; the call passes through to the engine unchanged."""

    def __init__(self, engine):
        self.engine, self.category_names, self.results = engine, engine.category_names, None

    def analyze_images_batch(self, paths, **kw):
        self.results = self.engine.analyze_images_batch(paths, **kw)
        return self.results


def _decisions(results: dict, items: list, root: str, cat: str) -> dict:
    """attribute_f1's decision per image in one category (the top-1 of a
    single-label category, the top-k set, k = min(5, |true|), of a
    multi-label one) with the analysis' scores beside."""
    single = {"styles": "style", "room_types": "room_type"}
    out = {}
    for item in items:
        path = os.path.join(root, item["image_path"])
        top = results[path]["analysis"][cat]
        if cat in single:
            if item.get(single[cat]):
                out[path] = ({top[0][0]}, dict(top))
        elif item.get(cat):
            out[path] = ({a for a, _ in top[: min(5, len(set(item[cat])))]}, dict(top))
    return out


def _hold_f1(label: str, card: tuple, cpu: tuple, items: list, root: str) -> list:
    """The card's attribute-F1 and per-image decisions against the CPU's:
    every score within SCORE_TOL, the decisions equal up to swaps of two
    attributes whose CPU scores differ by less than SWAP_TOL (each logged).
    Returns the swaps."""
    (f1, res), (f1_cpu, res_cpu) = card, cpu
    if set(res) != set(res_cpu) or not all(r.get("analysis") for r in res.values()):
        raise AssertionError(f"[eval {label}] results for {len(res)} images (CPU "
                             f"{len(res_cpu)}), or some without an analysis")
    swaps, bad = [], []
    for cat in f1:
        got, want = (_decisions(r, items, root, cat) for r in (res, res_cpu))
        for path, (dec, _) in got.items():
            dec_cpu, scores = want[path]
            if dec == dec_cpu:
                continue
            only_card, only_cpu = sorted(dec - dec_cpu), sorted(dec_cpu - dec)
            swap = len(only_card) == len(only_cpu) == 1
            gap = abs(scores[only_card[0]] - scores[only_cpu[0]]) if swap else np.inf
            case = (os.path.basename(path), cat, only_card, only_cpu, gap)
            (swaps if gap < SWAP_TOL else bad).append(case)
    for name, cat, a, b, gap in swaps:
        log(f"[eval {label}] swap on {name}, {cat}: card {a}, CPU {b} (CPU scores "
            f"{gap:.2e} apart)")
    dev = max(abs(sc - dict(res_cpu[p]["analysis"][c]).get(a, np.inf))
              for p, r in res.items() for c, top in r["analysis"].items() for a, sc in top)
    log(f"[eval {label}] max |attribute score, card - CPU| {dev:.3e} (bar {SCORE_TOL}); "
        f"decisions that differ beyond the swap bar: {bad}")
    if bad or dev > SCORE_TOL or (f1 != f1_cpu and not swaps):
        raise AssertionError(f"[eval {label}] the card's attribute-F1 departs from the CPU's: "
                             f"{f1} against {f1_cpu}; scores {dev:.3e} apart; decisions {bad}")
    return swaps


def _launches_since_reset(label: str, stage: str, want: dict) -> dict:
    from aiic_tpu_torch.ops._build import launch_counts

    got = {n: c for n, c in launch_counts().items() if c}
    want = {n: c for n, c in want.items() if c}
    log(f"[eval {label}] {stage}: launches {got} (expected {want})")
    if got != want:
        raise AssertionError(f"[eval {label}] {stage}: launched {got}, expected {want}")
    return got


def _tower_launches(opts: dict, config, n_images: int, n_texts: int, calls: int = 1) -> dict:
    """Launches of ``calls`` encode_image calls on n_images (the CLS-row
    block aside) and encode_text calls on n_texts (none where 0)."""
    want: dict = {}
    v, t = config.vision, config.text
    for seq, tower, bsz, layers in ((config.vision_seq_len, v, n_images, v.layers - 1),
                                    (config.context_length, t, n_texts, t.layers)):
        if bsz:
            for name in _block_kernels(opts, seq, tower.width, tower.heads, bsz):
                want[name] = want.get(name, 0) + layers * calls
    return want


def _start(cmd: list, root: str, name: str) -> tuple:
    """Start a tool as a process from ``root``, its output into files there."""
    env = {**os.environ, "PYTHONPATH": HERE + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = open(os.path.join(root, f"{name}.out"), "w")
    err = open(os.path.join(root, f"{name}.err"), "w")
    return (subprocess.Popen(cmd, cwd=root, env=env, stdout=out, stderr=err), out, err, name,
            time.perf_counter())


def _finish(job: tuple, root: str, timeout: float = 600) -> tuple:
    """Wait for a started tool: (its stdout, seconds), or a failure with its
    stderr. The process is killed if it outlives ``timeout``."""
    proc, out, err, name, t0 = job
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        out.close()
        err.close()
    seconds = time.perf_counter() - t0
    with open(os.path.join(root, f"{name}.out")) as f:
        stdout = f.read()
    with open(os.path.join(root, f"{name}.err")) as f:
        stderr = f.read()
    log(f"[eval {name}] exit code {rc} after {seconds:.1f} s")
    if rc != 0:
        raise AssertionError(f"[eval {name}] exited with {rc}:\n{stderr[-3000:]}")
    return stdout, seconds


def _f1_engines(params, device, items: list, root: str, card: str) -> dict:
    """(a): attribute_f1 on the int8 and bf16 engines on the card, with exact
    launches, against the same call on the CPU plain path."""
    import torch

    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.ops._build import reset_launch_counts
    from aiic_tpu_torch.train.metrics import attribute_f1
    from aiic_tpu_torch.utils.batching import bucket_size

    out: dict = {}
    for label in EVAL_CONFIGS:
        opts = CONFIGS[label]
        reset_launch_counts()
        engine = _engine(params, device, opts, VIT_B_16)
        torch.cuda.synchronize()
        n_prompts = engine.det_text.shape[0] + int(engine.cat_mask.sum())
        cap = engine.max_batch
        buckets = [bucket_size(len(items[i:i + cap]), cap) for i in range(0, len(items), cap)]
        want_build, want = _expected_launches(opts, VIT_B_16, n_prompts, buckets)
        _launches_since_reset(label, f"engine build ({n_prompts} prompts)", want_build)
        rec = _Recorded(engine)
        t0 = time.perf_counter()
        f1 = attribute_f1(rec, items, root)
        seconds = time.perf_counter() - t0
        got = _launches_since_reset(label, f"attribute_f1 on {len(items)} images in "
                                           f"{seconds:.2f} s (buckets {buckets})", want)
        rec_cpu = _Recorded(_engine(params, "cpu", opts, VIT_B_16))
        t0 = time.perf_counter()
        f1_cpu = attribute_f1(rec_cpu, items, root)
        cpu_s = time.perf_counter() - t0
        swaps = _hold_f1(label, (f1, rec.results), (f1_cpu, rec_cpu.results), items, root)
        interior = sum(r["is_interior"] for r in rec.results.values())
        log(f"[eval {label}] ({card}) attribute-F1 on the card: {json.dumps(f1)}; equal to the "
            f"CPU plain path's: {f1 == f1_cpu} ({len(swaps)} swaps); "
            f"{len(items) / seconds:.2f} images/s, decode included ({seconds:.2f} s; the CPU "
            f"{cpu_s:.2f} s); {interior} of {len(items)} judged interior")
        out[label] = {"f1": f1, "f1_cpu": f1_cpu, "equal": f1 == f1_cpu, "swaps": swaps,
                      "seconds": seconds, "images_per_s": len(items) / seconds,
                      "cpu_seconds": cpu_s, "launches": got}
        del engine, rec
    return out


def _eval_f1_twin(job: tuple, weights: str, device, items: list, root: str) -> dict:
    """(b): tools/torch_eval_f1.py as a process against the in-process call
    on the engine it builds (fp32, HWC wire, "auto": row 7 on the card)."""
    import torch

    from aiic_tpu_torch.data.dataset import load_training_data
    from aiic_tpu_torch.engine import InteriorAnalyzer
    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.models.init import load_clip_weights
    from aiic_tpu_torch.ops._build import reset_launch_counts
    from aiic_tpu_torch.train.metrics import attribute_f1
    from aiic_tpu_torch.utils.batching import bucket_size

    reset_launch_counts()
    engine = InteriorAnalyzer(
        params=load_clip_weights(weights, VIT_B_16, device=device), config=VIT_B_16,
        training_data=load_training_data(os.path.join(root, "interior_dataset.json")),
        lora_rank=4, lora_alpha=8, device=device)
    torch.cuda.synchronize()
    n_prompts = engine.det_text.shape[0] + int(engine.cat_mask.sum())
    want_build, want = _expected_launches(
        EVAL_F1_OPTS, VIT_B_16, n_prompts, [bucket_size(EVAL_F1_LIMIT, engine.max_batch)])
    _launches_since_reset("eval_f1", f"fp32 engine build ({n_prompts} prompts)", want_build)
    f1 = attribute_f1(engine, items[:EVAL_F1_LIMIT], root)
    got = _launches_since_reset("eval_f1", f"attribute_f1 on {EVAL_F1_LIMIT} images", want)
    stdout, seconds = _finish(job, root)
    printed = json.loads(stdout)
    log(f"[eval eval_f1] tools/torch_eval_f1.py --limit {EVAL_F1_LIMIT}: {json.dumps(printed)}; "
        f"equal to the in-process call: {printed == f1}")
    if printed != f1:
        raise AssertionError(f"[eval eval_f1] the tool printed {printed}, in process {f1}")
    return {"f1": f1, "tool_seconds": seconds, "launches": got}


def _detector(logits: np.ndarray) -> tuple:
    """(verdict, interior mass) of the reference's detector rule
    (main.py:208-220) on 40-prompt logits."""
    from aiic_tpu_torch.engine.detector import DEFAULT_CONFIDENCE_THRESHOLD, INTERIOR_COUNT

    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    mass = p[:, :INTERIOR_COUNT].sum(-1)
    return (mass > p[:, INTERIOR_COUNT:].sum(-1)) & (p.max(-1) > DEFAULT_CONFIDENCE_THRESHOLD), mass


def _parity(params, device, root: str, card: str) -> dict:
    """(c): the serving configuration's and the fp32 configuration's 40
    detector-prompt logits on the card (exact launches) against the port's
    fp32 plain path on the CPU, on the generated JPEGs."""
    import glob

    import torch
    from PIL import Image

    from aiic_tpu_torch.data.preprocess import preprocess_pil, preprocess_pil_u8
    from aiic_tpu_torch.data.tokenizer import tokenize_for_model
    from aiic_tpu_torch.engine.detector import DETECTOR_CATEGORIES
    from aiic_tpu_torch.models import VIT_B_16, encode_image, encode_text, normalize_features
    from aiic_tpu_torch.models.init import tree_map
    from aiic_tpu_torch.ops._build import reset_launch_counts
    from aiic_tpu_torch.ops.preprocess import to_patch_major
    from aiic_tpu_torch.ops.quant import quantize_model

    paths = sorted(glob.glob(os.path.join(root, "dataset_images", "*.jpg")))
    size = VIT_B_16.image_size
    hwc = np.stack([preprocess_pil(Image.open(p), size) for p in paths])
    patch = to_patch_major(np.stack([preprocess_pil_u8(Image.open(p), size) for p in paths]),
                           VIT_B_16.patch_size)
    tokens = torch.from_numpy(tokenize_for_model(DETECTOR_CATEGORIES, VIT_B_16).astype(np.int64))

    def logits(p, px, dtype, dev, attn_impl):
        with torch.inference_mode():
            img = normalize_features(encode_image(p, torch.from_numpy(px).to(dev), VIT_B_16,
                                                  dtype=dtype, attn_impl=attn_impl))
            txt = normalize_features(encode_text(p, tokens.to(dev), VIT_B_16, dtype=dtype,
                                                 attn_impl=attn_impl))
            return (100.0 * img @ txt.T).cpu().numpy()

    ref = logits(params, hwc, torch.float32, "cpu", "xla")
    on_card = tree_map(lambda t: t.to(device), params)
    serving = quantize_model(tree_map(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t, on_card))
    out: dict = {"images": len(paths)}
    for label, p, px, dtype, opts in (
            ("serving", serving, patch, torch.bfloat16, CONFIGS["int8"]),
            ("fp32", on_card, hwc, torch.float32, CONFIGS["fp32"])):
        reset_launch_counts()
        got = logits(p, px, dtype, device, "pallas")
        launches = _launches_since_reset(
            f"parity {label}", f"{len(paths)} images and {len(DETECTOR_CATEGORIES)} prompts",
            _tower_launches(opts, VIT_B_16, len(paths), len(DETECTOR_CATEGORIES)))
        a, b = got.ravel(), ref.ravel()
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        (v_card, m_card), (v_cpu, m_cpu) = _detector(got), _detector(ref)
        differ = [(os.path.basename(paths[i]), float(m_card[i]), float(m_cpu[i]))
                  for i in np.flatnonzero(v_card != v_cpu)]
        log(f"[eval parity {label}] ({card}) logit cosine against the CPU's fp32 plain path "
            f"{cos:.6f}, max |logit diff| {float(np.abs(a - b).max()):.5f}, verdict agreement "
            f"{float((v_card == v_cpu).mean()):.4f} ({int(v_cpu.sum())} of {len(paths)} interior "
            f"on the CPU)")
        for name, mc, mp in differ:
            log(f"[eval parity {label}] verdicts differ on {name}: interior mass card {mc:.5f}, "
                f"CPU {mp:.5f}")
        out[label] = {"logit_cosine": cos, "verdict_agreement": float((v_card == v_cpu).mean()),
                      "differing": differ, "launches": launches}
        if cos < PARITY_COS_MIN or (label == "fp32" and differ):
            raise AssertionError(f"[eval parity {label}] against the CPU: {out[label]}")
    return out


def _clip_forward_and_lora(params, device, root: str, card: str) -> dict:
    """(d): clip_forward in fp32 (row 7: 11 launches for the images, 12 for
    the text) and bf16 encode_image on fold_visual_lora's params (row 5)
    against the CPU; a zero-B fold bit for bit the unfolded features."""
    import glob

    import torch
    from PIL import Image

    from aiic_tpu_torch.adapters import LoRAConfig, fold_visual_lora, init_visual_lora
    from aiic_tpu_torch.data.preprocess import preprocess_numpy_batch
    from aiic_tpu_torch.data.tokenizer import tokenize_for_model
    from aiic_tpu_torch.engine.detector import DETECTOR_CATEGORIES
    from aiic_tpu_torch.models import VIT_B_16, clip_forward, encode_image
    from aiic_tpu_torch.models.init import tree_map
    from aiic_tpu_torch.ops._build import reset_launch_counts

    paths = sorted(glob.glob(os.path.join(root, "dataset_images", "*")))[:CLIP_FORWARD_IMAGES]
    px = torch.from_numpy(preprocess_numpy_batch(
        [np.asarray(Image.open(p).convert("RGB")) for p in paths], VIT_B_16.image_size))
    tokens = torch.from_numpy(tokenize_for_model(DETECTOR_CATEGORIES, VIT_B_16).astype(np.int64))
    on_card = tree_map(lambda t: t.to(device), params)
    out: dict = {}

    reset_launch_counts()
    with torch.inference_mode():
        per_image, per_text = (t.cpu().numpy() for t in clip_forward(
            on_card, px.to(device), tokens.to(device), VIT_B_16))
    want = _tower_launches(CONFIGS["fp32"], VIT_B_16, len(paths), len(tokens))
    # row 7 in every block but the CLS-row one, and in every text block (23)
    if want != {"fused_attention_qkv": VIT_B_16.vision.layers - 1 + VIT_B_16.text.layers}:
        raise AssertionError(f"clip_forward's planned launches {want}")
    out["clip_forward_launches"] = _launches_since_reset(
        "clip_forward", f"fp32, {len(paths)} images and {len(tokens)} prompts", want)
    with torch.inference_mode():
        ref = clip_forward(params, px, tokens, VIT_B_16)[0].numpy()
    rows = (per_image * ref).sum(-1) / (np.linalg.norm(per_image, axis=-1)
                                        * np.linalg.norm(ref, axis=-1))
    same_argmax = bool((per_image.argmax(-1) == ref.argmax(-1)).all()
                       and (per_text.argmax(-1) == ref.T.argmax(-1)).all())
    log(f"[eval clip_forward] ({card}) logits {per_image.shape} against the CPU: min row cosine "
        f"{rows.min():.6f}, max |diff| {float(np.abs(per_image - ref).max()):.5f}, argmax per "
        f"row equal {same_argmax}, logits_per_text the transpose "
        f"{bool((per_text == per_image.T).all())}")
    out["clip_forward"] = {"min_row_cos": float(rows.min()), "same_argmax": same_argmax}
    if rows.min() < 0.999 or not same_argmax or not (per_text == per_image.T).all():
        raise AssertionError(f"clip_forward on the card departs from the CPU: {out}")

    # The image tower's LoRA: a seeded rank-4 tree on all three attach points
    # with B drawn too, and a fresh (B = 0) one, both folded in fp32.
    lc = LoRAConfig(rank=4, alpha=8, attach=("out_proj", "c_fc", "c_proj"))
    gen = torch.Generator().manual_seed(31)
    tree = init_visual_lora(gen, VIT_B_16, lc, device="cpu")
    for ab in tree.values():
        ab["B"] = torch.randn(ab["B"].shape, generator=gen) * 0.02
    zero = init_visual_lora(torch.Generator().manual_seed(32), VIT_B_16, lc, device="cpu")
    folded = fold_visual_lora(params, tree, lc.scaling)
    reset_launch_counts()
    with torch.inference_mode():
        feats = [encode_image(p, px.to(device), VIT_B_16, dtype=torch.bfloat16).float().cpu()
                 for p in (fold_visual_lora(on_card, tree_map(lambda t: t.to(device), tree),
                                            lc.scaling),
                           fold_visual_lora(on_card, tree_map(lambda t: t.to(device), zero),
                                            lc.scaling),
                           on_card)]
    out["lora_launches"] = _launches_since_reset(
        "visual_lora", f"bf16 encode_image x3 on {len(paths)} images",
        _tower_launches(CONFIGS["bf16"], VIT_B_16, len(paths), 0, calls=3))
    with torch.inference_mode():
        cpu = encode_image(folded, px, VIT_B_16, dtype=torch.bfloat16).float()
    cos = torch.nn.functional.cosine_similarity(feats[0], cpu, dim=-1)
    moved = float((feats[0] - feats[2]).abs().max())
    zero_exact = bool(torch.equal(feats[1], feats[2]))
    log(f"[eval visual_lora] ({card}) folded rank-4 tree, bf16 on the card against the CPU: min "
        f"feature cosine {float(cos.min()):.6f}; max |feature change| from the adapter {moved:.6g};"
        f" the zero-B fold bit for bit the unfolded: {zero_exact}")
    out["visual_lora"] = {"min_feature_cos": float(cos.min()), "feature_change": moved,
                          "zero_b_bit_for_bit": zero_exact}
    if cos.min() < 0.999 or not zero_exact or not moved > 0:
        raise AssertionError(f"the visual LoRA fold on the card: {out['visual_lora']}")
    return out


def phase_eval(device, card: str) -> dict:
    """Phase 14: attribute-F1 on the int8 and bf16 engines and the eval_f1
    twin; the oracle check (in process against the CPU's fp32 plain path, and
    the parity_report twin against transformers.CLIPModel); clip_forward and
    the image tower's LoRA. Returns the launches."""
    import torch

    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.models.init import init_clip_params, save_clip_weights

    t0 = time.perf_counter()
    launches: dict = {}
    with tempfile.TemporaryDirectory() as root:
        items = _eval_dataset(root)
        # The CPU's generator, as in phase 13: the same weights on any machine.
        params = init_clip_params(VIT_B_16, torch.Generator().manual_seed(0), device="cpu")
        weights = os.path.join(root, "weights.npz")
        save_clip_weights(params, weights)
        # The three tool processes run beside the in-process parts (their
        # launches are their own); each is waited for below, and any still
        # running when a part fails is killed.
        tools = os.path.join(HERE, "tools")
        eval_job = _start([sys.executable, os.path.join(tools, "torch_eval_f1.py"),
                           "--dataset-json", os.path.join(root, "interior_dataset.json"),
                           "--weights", weights, "--limit", str(EVAL_F1_LIMIT)], root, "eval_f1")
        jobs = {"eval_f1": eval_job}
        try:
            for name, flags in PARITY_TWIN_FLAGS.items():
                jobs[name] = _start([sys.executable, os.path.join(tools, "torch_parity_report.py"),
                                     "--reference-root", root, "--limit", str(PARITY_TWIN_LIMIT)]
                                    + flags, root, name)
            report = _f1_engines(params, device, items, root, card)
            report["eval_f1"] = _eval_f1_twin(eval_job, weights, device, items, root)
            report["parity"] = _parity(params, device, root, card)
            report.update(_clip_forward_and_lora(params, device, root, card))
            for name in PARITY_TWIN_FLAGS:
                stdout, seconds = _finish(jobs[name], root)
                res = json.loads(stdout.strip().splitlines()[-1])
                log(f"[eval {name}] ({card}) tools/torch_parity_report.py "
                    f"{' '.join(PARITY_TWIN_FLAGS[name])} against transformers.CLIPModel: "
                    f"{json.dumps(res)}")
                report[name] = {**res, "seconds": seconds}
                if res["passes_0999_bar"] is not True or res["images"] != PARITY_TWIN_LIMIT:
                    raise AssertionError(f"[eval {name}] {res}")
        finally:
            for proc, out, err, *_ in jobs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
                out.close()
                err.close()
        for part in ([report[c]["launches"] for c in EVAL_CONFIGS]
                     + [report["eval_f1"]["launches"], report["clip_forward_launches"],
                        report["lora_launches"]]
                     + [report["parity"][c]["launches"] for c in ("serving", "fp32")]):
            _add(launches, part)
    report["seconds"] = time.perf_counter() - t0
    REPORT["eval"] = report
    log(f"[eval] ({card}) phase 14 took {report['seconds']:.1f} s; its launches {launches}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this smoke run needs one GPU")
    device = torch.device("cuda", 0)

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    REPORT["card"] = card

    from aiic_tpu_torch.ops._build import BUILD_INFO, load_library

    t0 = time.perf_counter()
    load_library()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {BUILD_INFO['seconds']:.2f} s; by source {BUILD_INFO['per_source_s']}): "
        f"{BUILD_INFO['path']}")
    REPORT["build"] = dict(BUILD_INFO)
    REPORT["attn_core_mma"] = mma_core_resources(BUILD_INFO["log"])
    log(f"[build] attn_core_mma (rows 6-8 bf16), attn_core_f32 (rows 6-7 fp32), core_bwd_mma "
        f"(row 9 bf16, rows 12 and 14's core; _f32 row 14's fp32 store), core_bwd_tiled (row 9 "
        f"fp32), mxu_wgmma (row 17) and wgmma_stage (rows 1-5 and 10-14's GEMM stage; the "
        f"folded c_proj, row 3's; block_*: rows 11-14's products), block_core_fwd_mma and "
        f"rank_* (rows 11-14's core forward and rank-r products): "
        f"{REPORT['attn_core_mma']}")

    worst = phase_kernels(device)
    worst.update(phase_zoo_kernels(device))
    phase_core_edge_kernels(device, worst)
    worst.update(phase_text_block_kernels(device))
    worst.update(phase_core_ops_kernels(device))
    phase_core_bwd_edge_kernels(device, worst)
    phase_core_f32_edge_kernels(device, worst)
    from aiic_tpu_torch.probes import kernel_experiments

    built = kernel_experiments.model(device)
    worst.update(phase_variant_kernels(device, built))
    engines, params, launches = phase_slice(device)
    for label in ("int8", "bf16"):
        phase_cpu_compare(label, engines[label], params)
    with tempfile.TemporaryDirectory() as root:
        train_launches, epoch_rates = phase_train(params, device, root)
        launches.update(train_launches)
        phase_train_compare(params, device)
        phase_lora_engines(params, device, engines["int8"], root)
    times = phase_timing(device, card, engines, params, worst)
    times.update(phase_core_ops_timing(device, card, params, worst))
    times.update(phase_variant_timing(device, card, built, worst))
    times["train_lora_epoch_images_per_s"] = epoch_rates
    del engines, params
    zoo_engines, zoo_launches = phase_zoo(device)
    _add(launches, zoo_launches)
    times.update(phase_zoo_timing(device, card, zoo_engines, worst))
    del zoo_engines
    _add(launches, phase_core_ops(device))
    _add(launches, phase_experiments(device, built))
    del built
    _add(launches, phase_rest(device, card))
    _add(launches, phase_eval(device, card))
    REPORT["wall_s"] = time.perf_counter() - T0
    log(f"[wall] chip_smoke.py took {REPORT['wall_s']:.1f} s ({card})")

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{"name": name, "route": "cuda", **meta, "launches": launches[name],
                "max_abs_err": worst[name], **{k: times[name][k] for k in keys},
                **({"variant": times[name]["variant"]} if "variant" in times[name] else {})}
               for name, meta in KERNELS.items()]
    # Row 7's entry is its fp32 form (the register-tiled core, with the
    # scalar core it replaced beside, and at 256 text rows); its bf16 form
    # runs on the tensor-core core, timed at the B/16 and L/14 shapes.
    row7 = next(k for k in kernels if k["name"] == "fused_attention_qkv")
    row7["scalar_ms"] = times["fused_attention_qkv"]["scalar_ms"]
    row7["text"] = {k: times["fused_attention_qkv_text"][k] for k in keys + ("scalar_ms",)}
    row7["text"]["max_abs_err"] = worst["fused_attention_qkv_text"]
    row7["bf16"] = {"source": KERNELS["fused_attention_qkv_headgroups"]["source"],
                    **{k: times["fused_attention_qkv_bf16"][k] for k in keys}}
    row7["bf16"]["max_abs_err"] = worst["fused_attention_qkv_bf16"]
    row7["bf16_l14"] = {k: times["fused_attention_qkv_bf16_l14"][k] for k in keys}
    row7["bf16_l14"]["max_abs_err"] = worst["fused_attention_qkv_bf16_l14"]
    # Rows 6 and 9 likewise: their entries are the fp32 forms (row 6 on the
    # register-tiled core, the scalar core beside); bf16 runs the tensor-core
    # kernels, row 9 timed at 256 text rows (bf16) and 256 ViT-B/16 images
    # (bf16_vit).
    row6 = next(k for k in kernels if k["name"] == "fused_attention")
    row6["scalar_ms"] = times["fused_attention"]["scalar_ms"]
    row6["bf16"] = {"source": KERNELS["fused_attention_qkv_headgroups"]["source"],
                    **{k: times["fused_attention_bf16"][k] for k in keys},
                    "max_abs_err": worst["fused_attention_bf16"]}
    # Row 9's entry is its fp32 form at 256 text rows (the register-tiled
    # passes); fp32 at 256 ViT-B/16 images and bf16 (the tensor-core passes)
    # at both shapes beside it, each with the scalar forms it replaced.
    row9 = next(k for k in kernels if k["name"] == "fused_attention_qkv_bwd")
    row9["replaced_forms_ms"] = times["fused_attention_qkv_bwd_text"]["replaced_forms_ms"]
    for tag, shape, suffix, source in (
            ("fp32_vit", "vit", "", KERNELS["fused_attention_qkv_bwd"]["source"]),
            ("bf16", "text", "_bf16", "aiic_tpu_torch/csrc/attn_core_bwd_mma.cuh"),
            ("bf16_vit", "vit", "_bf16", "aiic_tpu_torch/csrc/attn_core_bwd_mma.cuh")):
        t = times[f"fused_attention_qkv_bwd_{shape}{suffix}"]
        row9[tag] = {"source": source, **{k: t[k] for k in keys},
                     "replaced_forms_ms": t["replaced_forms_ms"],
                     "max_abs_err": max(worst["fused_attention_qkv_bwd" + suffix],
                                        worst[f"fused_attention_qkv_bwd_{shape}{suffix}"])}
    # Rows 1-5 and 10: the WMMA form each replaced and the stage yardstick beside
    # (rows 3 and 4 also at their second shape, row 3 with its folded c_proj
    # alone); the GEMM stage's entry is its c_fc product, every product
    # beside.
    for k in kernels:
        if k["name"] in ("int8_ln_qkv_attention", "int8_ln_mlp", "int8_ln_mlp_chunked",
                         "int8_block", "fused_ln_qkv_attention", "fused_ln_mlp"):
            k.update({f: times[k["name"]][f] for f in ("wmma_ms", "stage_yardstick_ms")})
        if k["name"] in ("fused_ln_qkv_attention", "fused_ln_mlp"):
            k["text"] = times[k["name"]]["text"]
        if k["name"] in ("int8_ln_mlp_chunked", "int8_block"):
            second = "l14_336" if k["name"] == "int8_ln_mlp_chunked" else "text"
            t = times[f"{k['name']}_{second}"]
            k[second] = {**{f: t[f] for f in keys + ("wmma_ms", "stage_yardstick_ms")},
                         "max_abs_err": worst[f"{k['name']}_{second}"]}
        if k["name"] == "int8_ln_mlp_chunked":
            k["folded_c_proj"] = {f: times[k["name"]]["folded_c_proj"][f] for f in (
                "ms", "bound_ms", "bound_by", "yardstick_ms")}
        elif k["name"] == "gemm_stage":
            k["products"] = times["gemm_stage"]["products"]
    # Rows 11-14: rows 11-12's entries are fp32 (one route); bf16 beside, and
    # for bf16 and int8 form 1 (the first design) timed right after form 0.
    form_keys = ("wmma_ms", "ms_before_wmma", "device_ms_by_stage", "wmma_device_ms_by_stage")
    for k in kernels:
        if k["name"] in ("text_block_fwd", "text_block_bwd"):
            t = times[k["name"] + "_bf16"]
            k["bf16"] = {**{f: t[f] for f in keys + form_keys},
                         "max_abs_err": worst[k["name"] + "_bf16"]}
            k.update({f: times[k["name"]][f] for f in ("device_ms_by_stage", "tile_ms",
                                                         "stage_yardstick_ms")})
        elif k["name"] in ("text_block_fwd_int8", "text_block_bwd_int8"):
            k.update({f: times[k["name"]][f] for f in form_keys})
    # Rows 15-16's entries are each wrapper's first variant in form 0; form 1
    # (the first design) beside, every variant in the report.
    for k in kernels:
        if "variant" in k:
            k["wmma"] = {"source": k["source"].replace("_wgmma", ""),
                         "ms": times[k["name"]]["wmma_ms"]}
    # Row 17's entries are the wgmma form; the WMMA form it replaced beside.
    for k in kernels:
        if k["name"].startswith("mxu_"):
            k["wmma"] = {"source": "aiic_tpu_torch/csrc/mxu_probe.cu",
                         "ms": times[k["name"]]["wmma_ms"],
                         "max_abs_err": worst[k["name"] + "_wmma"]}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(REPORT, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
