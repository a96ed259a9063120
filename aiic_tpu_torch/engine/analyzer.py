"""InteriorAnalyzer — the serving engine of the port (``aiic_tpu.engine.analyzer``).

Holds what the serving path needs: one CLIP backbone, the detector and
category text features precomputed once through the text tower, and the
classify program over power-of-two padded batches of uint8 pixels, on the
HWC wire (normalized on the device) or the patch-major wire. Results use the
reference schema of
``aiic_tpu.engine.analyzer.InteriorAnalyzer.analyze_images_batch``.

The configurations users run, and the kernels each runs in every block
(``models.clip.block``):

- ``dtype=torch.bfloat16, quantize=True``: int8 serving, the two int8
  half-block kernels, or the whole int8 block kernel where the JAX
  package's auto rule takes it (every text tower at an even prompt count,
  ViT-B/32 images at an even bucket);
- ``dtype=torch.bfloat16, quantize=False``: the worker's default, the bf16
  attention half-block kernel and a cuBLAS bf16 MLP, or with
  ``attn_impl="pallas_mlp"`` the fused LN+MLP kernel too;
- ``dtype=torch.float32``: the batch CLI's default, cuBLAS fp32 projections
  around the packed-QKV attention core kernel.

``config`` is any preset of ``models.config``: at ViT-L/14 and L/14@336 the
blocks follow the JAX planners to the chunked int8 MLP and the large-S
attention (``models.clip.block``).

``use_lora`` folds a text-tower adapter (a reference ``.pth``, a loaded
state dict, or a seeded no-op init) into the backbone before the int8
quantization and the text-feature precompute, as the JAX engine does.

File decoding, URL streams, the text-feature cache, device resize and
multi-card serving are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from aiic_tpu_torch.data.dataset import build_category_prompts, extract_all_categories
from aiic_tpu_torch.data.tokenizer import tokenize_for_model
from aiic_tpu_torch.engine.detector import (
    DEFAULT_CONFIDENCE_THRESHOLD,
    DETECTOR_CATEGORIES,
    INTERIOR_COUNT,
)
from aiic_tpu_torch.engine.programs import classify_batch, encode_texts_program
from aiic_tpu_torch.models.config import VIT_B_16, CLIPConfig
from aiic_tpu_torch.models.init import init_clip_params, tree_map
from aiic_tpu_torch.utils.batching import bucket_size, pad_batch


class InteriorAnalyzer:
    """Detector + multi-label attribute analyzer over one CLIP backbone.

    ``device`` is explicit and defaults to the first CUDA card: on a machine
    without one the engine fails instead of running on the CPU. Pass
    ``device="cpu"`` for the plain PyTorch path (every kernel's CPU version).
    """

    def __init__(
        self,
        params: Optional[Dict[str, Any]] = None,
        config: CLIPConfig = VIT_B_16,
        *,
        training_data: Optional[List[Dict[str, Any]]] = None,
        use_lora: bool = False,
        lora_weights_path: Union[str, Mapping[str, Any], None] = None,
        lora_rank: int = 4,
        lora_alpha: int = 8,
        dtype: torch.dtype = torch.bfloat16,
        quantize: bool = True,
        wire_format: str = "patch",
        attn_impl: str = "pallas",
        max_batch: int = 512,
        seed: int = 0,
        device="cuda",
    ):
        if wire_format not in ("hwc", "patch"):
            raise ValueError(f"wire_format must be 'hwc' or 'patch', got {wire_format!r}")
        self.config = config
        self.attn_impl = attn_impl
        self.dtype = dtype
        self.max_batch = max_batch
        self.wire_format = wire_format
        self.device = torch.device(device)

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_clip_params(config, gen, device=self.device)
        else:
            params = tree_map(lambda t: t.to(self.device), params)

        # LoRA: folded into the text tower before any quantization and the
        # text-feature precompute (the reference applies LoRA before its
        # text features, main.py:243-262)
        self.use_lora = use_lora
        if use_lora:
            from aiic_tpu_torch.adapters import (
                LoRAConfig, fold_text_lora, init_text_lora, lora_tree_from_pth,
            )

            lc = LoRAConfig(rank=lora_rank, alpha=lora_alpha, attach=("c_fc", "c_proj"))
            if lora_weights_path is not None and (not isinstance(lora_weights_path, str)
                                                  or os.path.exists(lora_weights_path)):
                tree, _ = lora_tree_from_pth(lora_weights_path, config, lc, seed=seed,
                                             device=self.device)
            else:
                tree = init_text_lora(torch.Generator(device=self.device).manual_seed(seed),
                                      config, lc, device=self.device)
            params = fold_text_lora(params, tree, lc.scaling)

        # int8 serving weights: active only on the bf16 path (models.clip.block).
        self.quantized = False
        if quantize and dtype != torch.bfloat16:
            warnings.warn(f"quantize=True ignored on the {dtype} path — the int8 kernels "
                          "engage only under dtype=bfloat16", stacklevel=2)
        elif quantize:
            from aiic_tpu_torch.ops.quant import quantize_model

            params = quantize_model(params)
            self.quantized = True
        self.params = params

        self.training_data = training_data or []
        self.all_categories = extract_all_categories(self.training_data)
        self.category_names = [k for k, v in self.all_categories.items() if v]
        self._precompute_text_features()

    @torch.inference_mode()
    def _precompute_text_features(self) -> None:
        """Detector + category prompts through the text tower in one batch."""
        config = self.config
        prompts_by_cat = build_category_prompts(self.all_categories)
        all_prompts = list(DETECTOR_CATEGORIES)
        spans = {}
        for name in self.category_names:
            start = len(all_prompts)
            all_prompts.extend(prompts_by_cat[name])
            spans[name] = (start, len(all_prompts))
        tokens = torch.from_numpy(tokenize_for_model(all_prompts, config)).to(self.device)
        feats = encode_texts_program(self.params, tokens, config=config, dtype=self.dtype,
                                     attn_impl=self.attn_impl)
        self.det_text = feats[: len(DETECTOR_CATEGORIES)]

        n_cat = len(self.category_names)
        max_n = max((e - s for s, e in spans.values()), default=1)
        cat_text = torch.zeros((max(n_cat, 1), max_n, config.embed_dim), device=self.device)
        cat_mask = torch.zeros((max(n_cat, 1), max_n), dtype=torch.bool, device=self.device)
        for ci, name in enumerate(self.category_names):
            s, e = spans[name]
            cat_text[ci, : e - s] = feats[s:e]
            cat_mask[ci, : e - s] = True
        self.cat_text = cat_text
        self.cat_mask = cat_mask

    # ------------------------------------------------------------------
    # Device passes
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _dispatch_chunk(self, chunk: np.ndarray, cap: int) -> tuple:
        """Repack to the wire, pad to the power-of-two bucket, run the
        classify program; returns (result tensors, valid rows)."""
        if self.wire_format == "patch" and chunk.ndim == 4 and chunk.dtype == np.uint8:
            from aiic_tpu_torch.ops.preprocess import to_patch_major

            chunk = to_patch_major(chunk, self.config.patch_size)
        padded, valid = pad_batch(chunk, bucket_size(len(chunk), cap))
        pixels = torch.from_numpy(padded).to(self.device, non_blocking=True)
        res = classify_batch(self.params, pixels, self.det_text, self.cat_text,
                             self.cat_mask, config=self.config,
                             interior_count=INTERIOR_COUNT, dtype=self.dtype,
                             attn_impl=self.attn_impl)
        return res, valid

    def classify_pixels(self, pixels: np.ndarray,
                        max_batch: Optional[int] = None) -> Dict[str, np.ndarray]:
        """(N, S, S, 3) uint8 (or normalized float) pixels -> classify
        results as numpy arrays, in chunks of at most ``max_batch`` rows each
        padded to a power-of-two bucket. All chunks are enqueued before any
        result is copied back."""
        cap = max_batch or self.max_batch
        pending = [self._dispatch_chunk(pixels[i: i + cap], cap)
                   for i in range(0, pixels.shape[0], cap)]
        outs = [{k: v[:valid].cpu().numpy() for k, v in res.items()} for res, valid in pending]
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]} if outs else {}

    # ------------------------------------------------------------------
    # Reference-schema results
    # ------------------------------------------------------------------

    def _assemble_analysis(self, res: Dict[str, np.ndarray], row: int) -> Dict[str, list]:
        analysis = {}
        for ci, name in enumerate(self.category_names):
            attrs = self.all_categories[name]
            k = min(5, len(attrs))
            vals = res["topk_vals"][row, ci, :k]
            idx = res["topk_idx"][row, ci, :k]
            analysis[name] = [(attrs[int(i)], float(v)) for v, i in zip(vals, idx)]
        return analysis

    def analyze_pixels(self, pixels_u8: np.ndarray, filter_interiors: bool = True,
                       confidence_threshold: float = DEFAULT_CONFIDENCE_THRESHOLD,
                       ) -> List[Dict[str, Any]]:
        """One result dict per image, assembled as ``analyze_images_batch``
        of the JAX engine assembles them."""
        res = self.classify_pixels(pixels_u8)
        results = []
        for row in range(len(pixels_u8)):
            conf = float(res["interior_mass"][row])
            top_conf = float(res["top_conf"][row])
            category = DETECTOR_CATEGORIES[int(res["top_idx"][row])]
            is_interior = (res["interior_mass"][row] > res["non_interior_mass"][row]
                           and top_conf > confidence_threshold)
            if filter_interiors and not is_interior:
                results.append({
                    "is_interior": False,
                    "interior_confidence": conf,
                    "detected_category": category,
                    "analysis": {},
                    "reason": f"Nie wnętrze: {category} (confidence: {conf:.3f})",
                })
            else:
                results.append({
                    "is_interior": True,
                    "interior_confidence": conf if filter_interiors else 1.0,
                    "detected_category": "interior",
                    "analysis": self._assemble_analysis(res, row),
                    "reason": "Success - interior image analyzed",
                })
        return results
