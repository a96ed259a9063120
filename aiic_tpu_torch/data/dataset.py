"""Dataset loading, attribute vocabulary and prompts — the parts of
``aiic_tpu.data.dataset`` that the serving engine and the trainer need,
copied.

- ``load_training_data``: reads ``{"training_data": [...]}`` (reference
  main.py:264-271).
- ``extract_all_categories``: the attribute vocabulary {styles,
  characteristics, materials, colors, room_types} of a training set, empty
  strings dropped, in first-seen order (reference main.py:273-294).
- ``build_category_prompts``: the Polish prompt templates — bare ``"{a}"``
  for room_types, ``"wnętrze z {a}"`` for everything else (reference
  main.py:296-311).
- ``build_training_prompts``: 1-4 prompts per item — ``"{style} wnętrze"``,
  ``"{room_type} w stylu {style}"``, ``"{char} {style} wnętrze"`` for the
  first two characteristics (reference train_lora.py:127-137).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence

CATEGORY_KEYS = ("styles", "characteristics", "materials", "colors", "room_types")


def load_training_data(json_path: str) -> List[Dict[str, Any]]:
    with open(json_path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return data.get("training_data", [])


def _ordered_unique(items) -> List[str]:
    return [k for k in dict.fromkeys(items) if k]


def extract_all_categories(training_data: Sequence[Dict[str, Any]]) -> Dict[str, List[str]]:
    styles, chars, mats, cols, rooms = [], [], [], [], []
    for item in training_data:
        styles.append(item.get("style", ""))
        rooms.append(item.get("room_type", ""))
        chars.extend(item.get("characteristics", []))
        mats.extend(item.get("materials", []))
        cols.extend(item.get("colors", []))
    return {
        "styles": _ordered_unique(styles),
        "characteristics": _ordered_unique(chars),
        "materials": _ordered_unique(mats),
        "colors": _ordered_unique(cols),
        "room_types": _ordered_unique(rooms),
    }


def build_category_prompts(categories: Dict[str, List[str]]) -> Dict[str, List[str]]:
    """Attribute -> text prompt, per category (reference main.py:302-305)."""
    prompts = {}
    for category, attributes in categories.items():
        if not attributes:
            continue
        if category == "room_types":
            prompts[category] = [f"{a}" for a in attributes]
        else:
            prompts[category] = [f"wnętrze z {a}" for a in attributes]
    return prompts


def build_training_prompts(item: Dict[str, Any]) -> List[str]:
    """1-4 candidate prompts per training item (reference train_lora.py:129-137)."""
    prompts = [f"{item['style']} wnętrze"]
    if item.get("room_type"):
        prompts.append(f"{item['room_type']} w stylu {item['style']}")
    if item.get("characteristics"):
        for char in item["characteristics"][:2]:
            prompts.append(f"{char} {item['style']} wnętrze")
    return prompts
