"""Zero-shot interior detector vocabulary and decision rule — a copy of
``aiic_tpu.engine.detector`` (whose package ``__init__`` pulls in JAX).

Indices 0-10 are "interior" categories, 11-39 are not. Over
``softmax(100 * cos)`` across all 40 categories,

    is_interior = (sum of interior probs > sum of non-interior probs)
                  AND (top-1 prob > confidence_threshold)

with the default threshold 0.3. ``tests/test_torch_bridge.py`` pins these
constants to the JAX module.
"""

DETECTOR_CATEGORIES = [
    # interiors — positive (indices 0-10)
    "interior of a room", "living room", "bedroom", "kitchen", "bathroom",
    "dining room", "office interior", "apartment interior", "house interior",
    "interior design", "home decor",
    # exteriors — negative
    "building exterior", "outside of building", "street view", "garden",
    "landscape", "cityscape", "outdoor",
    # plans and diagrams
    "floor plan", "blueprint", "architectural plan", "diagram",
    "map", "technical drawing",
    # logos and graphics
    "company logo", "brand logo", "text", "signature",
    "advertisement", "brochure", "flyer",
    # other unwanted
    "person", "people", "animal", "pet", "car", "vehicle",
    "close-up of object", "product photo", "furniture close-up",
]

INTERIOR_COUNT = 11
DEFAULT_CONFIDENCE_THRESHOLD = 0.3
