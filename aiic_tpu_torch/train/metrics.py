"""Attribute-F1 evaluation against the dataset labels — the port of
``aiic_tpu.train.metrics``.

BASELINE.md tracks "attribute-F1 parity vs reference on interior_dataset.json
labels". The reference never computes this; the defined protocol here:

- run the analyzer (no interior filtering) over every labeled image;
- single-label categories (style, room_type): top-1 prediction; report
  accuracy and micro-F1 (equal to accuracy for single-label);
- multi-label categories (characteristics, materials, colors): predict the
  top-k attributes where k = min(5, #true labels for that image); report
  micro-averaged precision/recall/F1 over all (image, attribute) decisions.

The analyzer is the port's ``InteriorAnalyzer``: on the card its classify
program launches the configuration's kernels, on the CPU their plain
versions.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Sequence

_SINGLE = {"styles": "style", "room_types": "room_type"}
_MULTI = {"characteristics": "characteristics", "materials": "materials", "colors": "colors"}


def attribute_f1(
    analyzer,
    training_data: Sequence[Dict[str, Any]],
    image_root: str = ".",
) -> Dict[str, Dict[str, float]]:
    paths = [os.path.join(image_root, item["image_path"]) for item in training_data]
    results = analyzer.analyze_images_batch(paths, filter_interiors=False)

    out: Dict[str, Dict[str, float]] = {}
    for cat in analyzer.category_names:
        tp = fp = fn = 0
        correct = total = 0
        for item, path in zip(training_data, paths):
            r = results.get(path)
            if not r or not r.get("analysis"):
                continue
            preds = [a for a, _ in r["analysis"].get(cat, [])]
            if cat in _SINGLE:
                true = item.get(_SINGLE[cat], "")
                if not true:
                    continue
                total += 1
                correct += int(preds and preds[0] == true)
            else:
                true_set = set(item.get(_MULTI[cat], []))
                if not true_set:
                    continue
                k = min(5, len(true_set))
                pred_set = set(preds[:k])
                tp += len(pred_set & true_set)
                fp += len(pred_set - true_set)
                fn += len(true_set - pred_set)
        if cat in _SINGLE:
            acc = correct / max(total, 1)
            out[cat] = {"top1_accuracy": acc, "f1": acc, "n": total}
        else:
            prec = tp / max(tp + fp, 1)
            rec = tp / max(tp + fn, 1)
            f1 = 2 * prec * rec / max(prec + rec, 1e-12)
            out[cat] = {"precision": prec, "recall": rec, "f1": f1, "n": tp + fn}
    return out
