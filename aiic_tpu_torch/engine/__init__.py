"""Serving engine of the port: detector rule, classify program, analyzer
(``aiic_tpu.engine``'s names)."""

from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer
from aiic_tpu_torch.engine.detector import (
    DEFAULT_CONFIDENCE_THRESHOLD,
    DETECTOR_CATEGORIES,
    INTERIOR_COUNT,
)

__all__ = [
    "DETECTOR_CATEGORIES",
    "INTERIOR_COUNT",
    "DEFAULT_CONFIDENCE_THRESHOLD",
    "InteriorAnalyzer",
]
