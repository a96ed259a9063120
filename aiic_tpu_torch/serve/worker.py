"""Apartment-analysis worker — the port of ``aiic_tpu.serve.worker``.

Per apartment: fetch the pending images -> decode -> one batched pass on
the card giving interior gate + room type + style per image -> per-image DB
updates (pending -> completed / not_interior) -> dominant-style and
room-distribution aggregation -> upserted apartment result -> JSON export.

Room type comes from the analyzer's room_types vocabulary; style from the
10 worker styles with the ``"wnętrze w stylu {s}"`` template
(main_API.py:150-162), whose text features go once through the port's
``encode_texts_program`` on the engine's device. The stored documents and
the export are the JAX package's.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from aiic_tpu_torch.data.dataset import WORKER_STYLES, build_worker_style_prompts
from aiic_tpu_torch.data.tokenizer import tokenize_for_model
from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer
from aiic_tpu_torch.engine.detector import DEFAULT_CONFIDENCE_THRESHOLD
from aiic_tpu_torch.engine.programs import encode_texts_program
from aiic_tpu_torch.serve.db import connect_db, seed_demo_data


class ApartmentWorker:
    def __init__(
        self,
        db,
        analyzer: Optional[InteriorAnalyzer] = None,
        *,
        styles: List[str] = WORKER_STYLES,
        confidence_threshold: float = DEFAULT_CONFIDENCE_THRESHOLD,
        **analyzer_kwargs,
    ):
        self.db = db
        self.analyzer = analyzer or InteriorAnalyzer(**analyzer_kwargs)
        self.styles = list(styles)
        self.confidence_threshold = confidence_threshold

        # Style text-feature cache (main_API.py:154-162 semantics): the text
        # tower on the engine's device, kept on the host in fp32
        a = self.analyzer
        tokens = tokenize_for_model(build_worker_style_prompts(self.styles), a.config)
        with torch.inference_mode():
            self.style_text = encode_texts_program(
                a.params, torch.from_numpy(tokens).to(a.device), config=a.config,
                dtype=a.dtype, attn_impl="xla").float().cpu()

    # ------------------------------------------------------------------

    def _room_type_for(self, res: Dict[str, np.ndarray], row: int) -> str:
        cats = self.analyzer.category_names
        if "room_types" in cats:
            ci = cats.index("room_types")
            idx = int(res["topk_idx"][row, ci, 0])
            return self.analyzer.all_categories["room_types"][idx]
        return "unknown"

    def _styles_for(self, feats: np.ndarray) -> List[Dict[str, Any]]:
        """Batched style classification (implements the main_API.py:268-271
        stub): softmax(100*cos) over the 10 worker styles, top-1."""
        sims = torch.softmax(100.0 * torch.from_numpy(feats).float() @ self.style_text.T,
                             dim=-1).numpy()
        out = []
        for row in sims:
            i = int(row.argmax())
            out.append({"style": self.styles[i], "confidence": float(row[i])})
        return out

    @staticmethod
    def calculate_dominant_style(room_analyses: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Implements the main_API.py:273-276 stub: most frequent style,
        confidence = mean style confidence among its images."""
        if not room_analyses:
            return {"style": "unknown", "confidence": 0.0}
        counts = Counter(r["style"] for r in room_analyses)
        style, _ = counts.most_common(1)[0]
        confs = [r["style_confidence"] for r in room_analyses if r["style"] == style]
        return {"style": style, "confidence": float(np.mean(confs))}

    @staticmethod
    def calculate_room_distribution(room_analyses: List[Dict[str, Any]]) -> Dict[str, int]:
        """Implements the main_API.py:278-281 stub: room_type -> count."""
        return dict(Counter(r["room_type"] for r in room_analyses))

    # ------------------------------------------------------------------

    def analyze_apartment(self, apartment_id, batch_size: int = 8) -> Optional[Dict[str, Any]]:
        """``batch_size`` caps the device bucket for this apartment's batched
        classify pass (reference --batch-size semantics, main_API.py:349)."""
        data = self.db.get_apartment_with_images(apartment_id)
        if not data or not data.get("images"):
            return None

        # Concurrent fetch and the native decode pool (JPEG/PNG/WebP,
        # PIL-exact numerics).
        from concurrent.futures import ThreadPoolExecutor

        from aiic_tpu_torch.data.native_loader import preprocess_any_batch
        from aiic_tpu_torch.data.pipeline import fetch_source

        images = data["images"]
        with ThreadPoolExecutor(max_workers=min(8, len(images))) as pool:
            blobs = list(pool.map(lambda im: fetch_source(im["url"]), images))
        pixels, ok = preprocess_any_batch(
            blobs, self.analyzer.config.image_size)

        metas = []
        for img_data, good in zip(images, ok):
            if good:
                metas.append(img_data)
            elif hasattr(self.db, "mark_image_attempt"):
                # failure accounting + dead-letter after repeated failures
                self.db.mark_image_attempt(img_data["_id"], "load failed")

        if not metas:
            return None

        res = self.analyzer.classify_pixels(pixels[ok], max_batch=batch_size)
        style_preds = self._styles_for(res["features"])

        room_analyses = []
        for row, img_data in enumerate(metas):
            is_interior = (
                res["interior_mass"][row] > res["non_interior_mass"][row]
                and float(res["top_conf"][row]) > self.confidence_threshold
            )
            if not is_interior:
                self.db.update_image_analysis(img_data["_id"], "not_interior", "unknown", 0.0)
                continue
            room_type = self._room_type_for(res, row)
            style = style_preds[row]
            self.db.update_image_analysis(
                img_data["_id"], room_type, style["style"], style["confidence"]
            )
            room_analyses.append({
                "room_type": room_type,
                "style": style["style"],
                "style_confidence": style["confidence"],
                "detection_confidence": float(res["interior_mass"][row]),
            })

        # Aggregate over the DB's stored per-image results for the WHOLE
        # apartment, not just this run's batch: a worker killed mid-apartment
        # leaves k images completed; the restarted worker re-drains only the
        # remaining pending ones, and this read folds the pre-crash results
        # back into the totals — the crash-recovery story the reference only
        # gestures at with `restart: always` (docker-compose.yml:8) + status
        # fields (main_API.py:78-91).
        if hasattr(self.db, "get_images_for_apartment"):
            stored = self.db.get_images_for_apartment(apartment_id)
            room_analyses = [
                {"room_type": im.get("room_type", "unknown"),
                 "style": im.get("style", "unknown"),
                 "style_confidence": float(im.get("analysis_confidence", 0.0)),
                 "detection_confidence": 1.0}
                for im in stored if im.get("analysis_status") == "completed"
            ]
            total = len(stored)
        else:  # duck-typed external DB without the recovery read
            total = len(data["images"])
        result = {
            "apartment_id": apartment_id,
            "total_images": total,
            "interior_images": len(room_analyses),
            "overall_style": self.calculate_dominant_style(room_analyses),
            "room_distribution": self.calculate_room_distribution(room_analyses),
        }
        self.db.save_apartment_analysis(apartment_id, result)
        return result


def process_apartments_pipeline(
    use_lora: bool = False,
    lora_weights: Optional[str] = None,
    max_apartments: Optional[int] = None,
    batch_size: int = 8,
    confidence_threshold: float = DEFAULT_CONFIDENCE_THRESHOLD,
    *,
    db=None,
    analyzer: Optional[InteriorAnalyzer] = None,
    seed_demo: bool = False,
    export_file: str = "analysis_export.json",
    log=print,
) -> Optional[str]:
    """Worker main loop (reference main_API.py:285-339 contract)."""
    db = db or connect_db()
    if seed_demo and hasattr(db, "insert_apartment"):
        seed_demo_data(db)

    pending = db.get_pending_apartments()
    if not pending:
        log("no pending apartments")
        return None
    if max_apartments:
        pending = pending[:max_apartments]

    analyzer_kwargs = {}
    if analyzer is None:
        analyzer_kwargs = {"use_lora": use_lora, "lora_weights_path": lora_weights}
    worker = ApartmentWorker(
        db, analyzer, confidence_threshold=confidence_threshold, **analyzer_kwargs
    )

    successful = 0
    for apt in pending:
        try:
            if worker.analyze_apartment(apt["_id"], batch_size=batch_size):
                successful += 1
        except Exception as e:  # per-apartment isolation (main_API.py:329-330)
            log(f"apartment {apt['_id']} failed: {e}")

    log(f"processed {successful}/{len(pending)} apartments")
    return db.export_analysis_results(export_file)
