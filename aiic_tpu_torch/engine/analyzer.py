"""InteriorAnalyzer — the serving engine of the port (``aiic_tpu.engine.analyzer``).

Holds what the serving path needs: one CLIP backbone, the detector and
category text features precomputed once through the text tower (or read
from a ``text_cache`` npz, which either package writes), and the classify
program over power-of-two padded batches of uint8 pixels, on the HWC wire
(normalized on the device) or the patch-major wire. Results use the
reference schema of ``aiic_tpu.engine.analyzer.InteriorAnalyzer``.

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

The serving surface is the JAX engine's: ``dispatch_pixels`` /
``fetch_results`` (the batcher's pipelined pair; the fetch starts every
device-to-host copy, into pinned host memory, before it waits on any),
``warmup``, ``analyze_images_batch`` over files, URLs and bytes (streamed
through ``data.pipeline``; ``device_resize`` resizes on the device), the
single-image helpers, and the ``decode`` / ``dispatch`` / ``fetch`` /
``decode_stall`` stage timings on ``metrics.stages``. Multi-device serving
(``mesh``) is not ported: the engine serves from one device.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from aiic_tpu_torch.data.dataset import (
    build_category_prompts, extract_all_categories, load_training_data,
)
from aiic_tpu_torch.data.images import load_image
from aiic_tpu_torch.data.preprocess import preprocess_pil, preprocess_pil_u8
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

NO_MESH = ("mesh serving is not ported: the port's engine serves from one device "
           "(pass mesh=None)")


class InteriorAnalyzer:
    """Detector + multi-label attribute analyzer over one CLIP backbone.

    The options both packages share default as in the JAX engine: fp32, no
    int8 weights, the HWC wire, ``attn_impl="auto"`` (``"pallas"`` on the
    card: the fp32 engine runs the packed-QKV core kernel).

    ``device`` is explicit and defaults to the first CUDA card: on a machine
    without one the engine fails instead of running on the CPU. Pass
    ``device="cpu"`` for the plain PyTorch path (every kernel's CPU version).
    """

    def __init__(
        self,
        params: Optional[Dict[str, Any]] = None,
        config: CLIPConfig = VIT_B_16,
        *,
        dataset_json: str = "interior_dataset.json",
        training_data: Optional[List[Dict[str, Any]]] = None,
        use_lora: bool = False,
        lora_weights_path: Union[str, Mapping[str, Any], None] = None,
        lora_rank: int = 4,
        lora_alpha: int = 8,
        dtype: torch.dtype = torch.float32,
        quantize: bool = False,
        wire_format: str = "hwc",
        attn_impl: str = "auto",
        max_batch: int = 512,
        seed: int = 0,
        text_cache: Optional[str] = None,
        mesh=None,
        metrics=None,
        device="cuda",
    ):
        if wire_format not in ("hwc", "patch"):
            raise ValueError(f"wire_format must be 'hwc' or 'patch', got {wire_format!r}")
        if mesh is not None:
            raise ValueError(NO_MESH)
        self.config = config
        self.attn_impl = attn_impl
        self.dtype = dtype
        self.max_batch = max_batch
        self.wire_format = wire_format
        self.mesh = None
        self.device = torch.device(device)
        if metrics is None:
            from aiic_tpu_torch.serve.metrics import GLOBAL_METRICS

            metrics = GLOBAL_METRICS
        # Per-stage timings (decode / dispatch / fetch / decode_stall) land
        # on metrics.stages and surface on GET /metrics.
        self.metrics = metrics

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_clip_params(config, gen, device=self.device)
        else:
            # Real backbone weights with the hermetic fallback vocabulary give
            # silently wrong text features: every one is built from tokens
            # the real embedding table never saw.
            from aiic_tpu_torch.data.tokenizer import _default_tokenizer

            if _default_tokenizer().hermetic:
                warnings.warn(
                    "InteriorAnalyzer: real backbone weights are loaded but the tokenizer "
                    "is running the HERMETIC fallback vocabulary (no "
                    "bpe_simple_vocab_16e6.txt.gz found). Text features will NOT match "
                    "OpenAI CLIP. Set AIIC_BPE_PATH to the real merges file.",
                    stacklevel=2)
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

        # Attribute vocabulary from the dataset (main.py:259-262), as the JAX
        # engine builds it: ``dataset_json`` where no ``training_data`` is
        # given and the file exists, else none.
        if training_data is None:
            training_data = (load_training_data(dataset_json) if os.path.exists(dataset_json)
                             else [])
        self.training_data = training_data
        self.all_categories = extract_all_categories(self.training_data)
        self.category_names = [k for k, v in self.all_categories.items() if v]

        # A persisted text-feature cache skips the text tower; its npz keys and
        # dtypes are the JAX engine's, so either package reads the other's.
        if text_cache and os.path.exists(text_cache):
            with np.load(text_cache, allow_pickle=False) as blob:
                self.det_text, self.cat_text, self.cat_mask = (
                    torch.from_numpy(blob[k]).to(self.device)
                    for k in ("det_text", "cat_text", "cat_mask"))
        else:
            self._precompute_text_features()
            if text_cache:
                np.savez(text_cache, det_text=self.det_text.cpu().numpy(),
                         cat_text=self.cat_text.cpu().numpy(),
                         cat_mask=self.cat_mask.cpu().numpy())
        # Per-geometry resize + classify programs (the device_resize path).
        self._resize_programs: Dict[tuple, Any] = {}

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

    def _preprocess_host(self, img) -> np.ndarray:
        """PIL image -> host pixels in the engine's wire format: normalized
        float32 HWC (the reference-exact parity form), or the uint8
        resize+crop when ``wire_format='patch'`` (``_dispatch_chunk``
        repacks it to patch-major)."""
        if self.wire_format == "patch":
            return preprocess_pil_u8(img, self.config.image_size)
        return preprocess_pil(img, self.config.image_size)

    def warmup(self, batch_sizes: Optional[Sequence[int]] = None) -> None:
        """Run the classify program once at each of the given batch buckets
        (default: every power of two up to max_batch), deduplicated on the
        bucket a live request of that size would run."""
        if batch_sizes is None:
            batch_sizes = []
            b = 1
            while b <= self.max_batch:
                batch_sizes.append(b)
                b <<= 1
        s = self.config.image_size
        seen = set()
        for b in batch_sizes:
            cap = max(self.max_batch, b)
            fb = self._final_bucket(b, cap)
            if fb in seen:
                continue
            seen.add(fb)
            # the same cap as the dedupe key: a size above max_batch runs its
            # own bucket, not max_batch-row chunks
            self.classify_pixels(np.zeros((b, s, s, 3), np.uint8), max_batch=cap)

    def classify_pixels(self, pixels: np.ndarray,
                        max_batch: Optional[int] = None) -> Dict[str, np.ndarray]:
        """(N, S, S, 3) uint8 (or normalized float) pixels -> classify
        results as numpy arrays, in chunks of at most ``max_batch`` rows each
        padded to a power-of-two bucket. All chunks are enqueued before any
        result is copied back. ``max_batch`` overrides the engine's ceiling
        for this call only."""
        return self._fetch_pending(self.dispatch_pixels(pixels, max_batch))

    def dispatch_pixels(self, pixels: np.ndarray,
                        max_batch: Optional[int] = None) -> List[tuple]:
        """Dispatch-only half of ``classify_pixels``: enqueue the classify
        program for each chunk and return the pending handle without
        copying results back. ``fetch_results`` resolves it; the serving
        batcher overlaps batch i's fetch with batch i+1's dispatch."""
        cap = max_batch or self.max_batch
        pending: List[tuple] = []
        i = 0
        while i < pixels.shape[0]:
            chunk = pixels[i: i + cap]
            pending.append(self._dispatch_chunk(chunk, cap))
            i += len(chunk)
        return pending

    def fetch_results(self, pending: List[tuple]) -> Dict[str, np.ndarray]:
        """Blocking half of the dispatch/fetch pair: a ``dispatch_pixels``
        handle -> the classify result dict."""
        return self._fetch_pending(pending)

    def _final_bucket(self, n: int, cap: int) -> int:
        """The bucket a request of n rows runs: its power-of-two bucket (one
        device, so no device-count multiple)."""
        return bucket_size(n, cap)

    @torch.inference_mode()
    def _dispatch_chunk(self, chunk: np.ndarray, cap: int) -> tuple:
        """Repack to the wire, pad to the bucket, copy to the device and
        enqueue the classify program; returns (result tensors, valid rows)."""
        if self.wire_format == "patch" and chunk.ndim == 4 and chunk.dtype == np.uint8:
            from aiic_tpu_torch.ops.preprocess import to_patch_major

            chunk = to_patch_major(chunk, self.config.patch_size)
        padded, valid = pad_batch(chunk, self._final_bucket(len(chunk), cap))
        with self.metrics.stages.stage("dispatch"):
            pixels = torch.from_numpy(padded).to(self.device, non_blocking=True)
            res = classify_batch(self.params, pixels, self.det_text, self.cat_text,
                                 self.cat_mask, config=self.config,
                                 interior_count=INTERIOR_COUNT, dtype=self.dtype,
                                 attn_impl=self.attn_impl)
        return res, valid

    def _resize_classify_for(self, geometry: tuple):
        """(program, Ky, Kx) for raw uint8 (B, H, W, 3) of one fixed source
        geometry: the bicubic resize, center crop and normalize on the device
        (``ops.preprocess.device_preprocess_fixed``), then the classify
        program."""
        prog = self._resize_programs.get(geometry)
        if prog is None:
            from aiic_tpu_torch.ops.preprocess import device_preprocess_fixed, make_resize_mats

            h, w = geometry
            ky, kx, top, left = make_resize_mats(h, w, self.config.image_size)
            size, dtype, config, attn_impl = (self.config.image_size, self.dtype, self.config,
                                              self.attn_impl)

            @torch.inference_mode()
            def fn(params, raw_u8, ky, kx, det_text, cat_text, cat_mask):
                px = device_preprocess_fixed(raw_u8, ky, kx, top, left, size, dtype=dtype)
                return classify_batch(params, px, det_text, cat_text, cat_mask, config=config,
                                      interior_count=INTERIOR_COUNT, dtype=dtype,
                                      attn_impl=attn_impl)

            prog = (fn, torch.from_numpy(ky).to(self.device), torch.from_numpy(kx).to(self.device))
            self._resize_programs[geometry] = prog
        return prog

    def _analyze_device_resize(self, image_paths, batch_size, record_load_error):
        """Decode-only on the host, resize on the device, grouped by source
        geometry (each distinct geometry is one group; a group dispatches
        when it reaches the cap and at the end). Returns (merged results or
        None, good paths in result-row order)."""
        from aiic_tpu_torch.data.native_loader import decode_jpeg_raw

        cap = batch_size or self.max_batch
        pending: List[tuple] = []
        good_paths: List[str] = []
        groups: Dict[tuple, list] = {}

        def flush(geom):
            # dispatch a full (or final partial) group and drop its host
            # copies: memory stays bounded by cap rows per active geometry
            items = groups.pop(geom, [])
            if not items:
                return
            fn, ky, kx = self._resize_classify_for(geom)
            raw = np.stack([a for _, a in items])
            padded, valid = pad_batch(raw, bucket_size(len(items), cap))
            with self.metrics.stages.stage("dispatch"):
                res = fn(self.params, torch.from_numpy(padded).to(self.device), ky, kx,
                         self.det_text, self.cat_text, self.cat_mask)
            pending.append((res, valid))
            good_paths.extend(p for p, _ in items)

        for p in image_paths:
            with self.metrics.stages.stage("decode"):
                try:
                    with open(p, "rb") as f:
                        blob = f.read()
                except OSError:
                    blob = b""
                arr = decode_jpeg_raw(blob)
            if arr is None:
                record_load_error(p)
                continue
            geom = arr.shape[:2]
            groups.setdefault(geom, []).append((p, arr))
            if len(groups[geom]) >= cap:
                flush(geom)
        for geom in list(groups):
            flush(geom)
        if not pending:
            return None, good_paths
        return self._fetch_pending(pending), good_paths

    def _fetch_pending(self, pending: List[tuple]) -> Dict[str, np.ndarray]:
        """Copy back and merge a list of (result tensors, valid rows)
        dispatches. On the card every device-to-host copy is started, as a
        non-blocking copy into pinned host memory, before the one wait."""
        with self.metrics.stages.stage("fetch"):
            staged = []
            on_card = False
            for res, valid in pending:
                out = {}
                for k, v in res.items():
                    v = v[:valid]
                    if v.device.type == "cuda":
                        host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                        host.copy_(v, non_blocking=True)
                        v, on_card = host, True
                    out[k] = v
                staged.append(out)
            if on_card:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                done.synchronize()
            outs = [{k: v.numpy() for k, v in o.items()} for o in staged]
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]} if outs else {}

    def _consume_loader(self, loader, image_paths, cap, good_paths,
                        record_load_error) -> Optional[Dict[str, np.ndarray]]:
        """Drain a prefetching loader (PrefetchingLoader or ByteStreamLoader:
        (pixels, ok, index range) batches): record per-path load errors,
        dispatch the kept rows, fetch once at the end. Returns the merged
        classify results, or None when nothing decoded."""
        pending: List[tuple] = []
        it = iter(loader)
        try:
            while True:
                # decode_stall: time the device sat waiting on the host
                # decoder (0 when decode fully overlaps compute)
                with self.metrics.stages.stage("decode_stall"):
                    item = next(it, None)
                if item is None:
                    break
                pixels_u8, ok, (start, end) = item
                for j in range(start, end):
                    if ok[j - start]:
                        good_paths.append(image_paths[j])
                    else:
                        record_load_error(image_paths[j])
                kept = pixels_u8[ok]
                if len(kept):
                    pending.append(self._dispatch_chunk(kept, cap))
        except Exception:
            # a dispatch failure abandons the stream: release its producer
            # thread and fetch pool
            it.close()
            raise
        if not pending:
            return None
        return self._fetch_pending(pending)

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

    @staticmethod
    def _verdict(res: Dict[str, np.ndarray], row: int, confidence_threshold: float):
        """The detector rule on one row: (is_interior, interior confidence,
        top category)."""
        is_interior = bool(res["interior_mass"][row] > res["non_interior_mass"][row]
                           and float(res["top_conf"][row]) > confidence_threshold)
        return (is_interior, float(res["interior_mass"][row]),
                DETECTOR_CATEGORIES[int(res["top_idx"][row])])

    def _result(self, res: Dict[str, np.ndarray], row: int, filter_interiors: bool,
                confidence_threshold: float) -> Dict[str, Any]:
        """One image's five-key result dict (main.py:383-391, 461-467)."""
        is_interior, conf, category = self._verdict(res, row, confidence_threshold)
        if filter_interiors and not is_interior:
            return {
                "is_interior": False,
                "interior_confidence": conf,
                "detected_category": category,
                "analysis": {},
                "reason": f"Nie wnętrze: {category} (confidence: {conf:.3f})",
            }
        return {
            "is_interior": True,
            "interior_confidence": conf if filter_interiors else 1.0,
            "detected_category": "interior",
            "analysis": self._assemble_analysis(res, row),
            "reason": "Success - interior image analyzed",
        }

    def analyze_pixels(self, pixels_u8: np.ndarray, filter_interiors: bool = True,
                       confidence_threshold: float = DEFAULT_CONFIDENCE_THRESHOLD,
                       ) -> List[Dict[str, Any]]:
        """One result dict per image, assembled as ``analyze_images_batch``
        of the JAX engine assembles them."""
        res = self.classify_pixels(pixels_u8)
        return [self._result(res, row, filter_interiors, confidence_threshold)
                for row in range(len(pixels_u8))]

    def analyze_images_batch(
        self,
        image_paths: Sequence[str],
        batch_size: Optional[int] = None,
        filter_interiors: bool = True,
        confidence_threshold: float = DEFAULT_CONFIDENCE_THRESHOLD,
        max_workers: int = 8,
        device_resize: bool = False,
        fast_decode: bool = False,
    ) -> Dict[str, Dict[str, Any]]:
        """Batch pipeline with the reference's result contract
        (main.py:371-469): every input path maps to a result dict.
        ``batch_size`` caps the device bucket for this call only.
        ``device_resize``: decode-only on the host, the bicubic resize on the
        device (local JPEGs only, grouped by source geometry).
        ``fast_decode``: DCT-scaled JPEG decode on the streaming path
        (quality-approximate, not bit-exact PIL preprocessing); ignored by
        the device_resize path."""
        results: Dict[str, Dict[str, Any]] = {}
        good_paths: List[str] = []

        def record_load_error(path):
            # Under filter_interiors the reference routes load failures
            # through the filter stage as non-interiors (main.py:330,
            # 353-358); with the filter off they surface as load errors
            # (main.py:420-426).
            if filter_interiors:
                reason = "Nie wnętrze: load error (confidence: 0.000)"
            else:
                reason = "Błąd ładowania: could not load image"
            results[path] = {
                "is_interior": False,
                "interior_confidence": 0.0,
                "detected_category": "load error",
                "analysis": {},
                "reason": reason,
            }

        local_jpegs = all(
            not p.startswith("http") and p.lower().endswith((".jpg", ".jpeg"))
            for p in image_paths
        ) and len(image_paths) > 0
        if local_jpegs and device_resize:
            res, good_paths = self._analyze_device_resize(image_paths, batch_size,
                                                          record_load_error)
        else:
            from aiic_tpu_torch.data.pipeline import ByteStreamLoader, PrefetchingLoader

            cap = batch_size or self.max_batch
            wire_patch = self.config.patch_size if self.wire_format == "patch" else 0
            if local_jpegs:
                # local JPEGs: batch i+1 decodes on the host while batch i runs
                # on the device; the decode pool emits the wire layout
                loader = PrefetchingLoader(list(image_paths), batch_size=cap,
                                           size=self.config.image_size, fast=fast_decode,
                                           patch=wire_patch)
            else:
                # URLs, other formats, mixed inputs: fetch i+1 || decode i ||
                # device i-1
                loader = ByteStreamLoader(list(image_paths), batch_size=cap,
                                          size=self.config.image_size,
                                          fetch_workers=max_workers, fast=fast_decode,
                                          patch=wire_patch)
            res = self._consume_loader(loader, image_paths, cap, good_paths,
                                       record_load_error)
        if res is None:
            return results
        for row, path in enumerate(good_paths):
            results[path] = self._result(res, row, filter_interiors, confidence_threshold)
        return results

    def filter_interior_images(
        self,
        image_paths: Sequence[str],
        confidence_threshold: float = DEFAULT_CONFIDENCE_THRESHOLD,
        max_workers: int = 8,
    ):
        """Standalone interior filter (reference main.py:313-369 contract):
        (interior_images, non_interior_info), interior_images a list of
        (path, pixels, confidence), gated in one batched device pass."""
        from concurrent.futures import ThreadPoolExecutor

        def fetch(p):
            img = load_image(p)
            return p, None if img is None else self._preprocess_host(img)

        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            fetched = list(pool.map(fetch, image_paths))

        interior_images, non_interior_info = [], []
        good = [(p, px) for p, px in fetched if px is not None]
        for p, px in fetched:
            if px is None:
                non_interior_info.append({
                    "path": p, "confidence": 0.0, "category": "load error",
                    "reason": "Nie wnętrze: load error (confidence: 0.000)",
                })
        if good:
            res = self.classify_pixels(np.stack([px for _, px in good]))
            for row, (p, px) in enumerate(good):
                is_interior, conf, category = self._verdict(res, row, confidence_threshold)
                if is_interior:
                    interior_images.append((p, px, conf))
                else:
                    non_interior_info.append({
                        "path": p, "confidence": conf, "category": category,
                        "reason": f"Nie wnętrze: {category} (confidence: {conf:.3f})",
                    })
        return interior_images, non_interior_info

    def is_interior_image(self, image,
                          confidence_threshold: float = DEFAULT_CONFIDENCE_THRESHOLD):
        """Single-image detector (reference main.py:191-226 contract):
        (is_interior, interior_confidence, top_category)."""
        if image is None:
            return False, 0.0, "invalid image"
        return self._verdict(self.classify_pixels(self._preprocess_host(image)[None]), 0,
                             confidence_threshold)

    def analyze_image_from_url(self, url: str, filter_interiors: bool = True) -> Dict[str, Any]:
        """Single-URL convenience wrapper (reference main.py:472-498)."""
        img = load_image(url)
        if img is None:
            return {"is_interior": False, "reason": "Failed to load image"}
        res = self.classify_pixels(self._preprocess_host(img)[None])
        is_interior, conf, category = self._verdict(res, 0, DEFAULT_CONFIDENCE_THRESHOLD)
        if filter_interiors and not is_interior:
            return {
                "is_interior": False,
                "interior_confidence": conf,
                "detected_category": category,
                "analysis": {},
                "reason": f"Not an interior image: {category}",
            }
        return {
            "is_interior": True,
            "interior_confidence": conf if filter_interiors else 1.0,
            "detected_category": "interior",
            "analysis": self._assemble_analysis(res, 0),
            "reason": "Success - interior image analyzed",
        }
