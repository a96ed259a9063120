"""Image acquisition — a copy of ``aiic_tpu.data.images`` (no JAX in it).

File / URL / CSV loaders: a 30 s HTTP GET (``requests``, imported only for
http(s) sources), RGB convert, ``None`` on failure; CSV columns ``offer_id,
seq, url`` with an optional ``max_images`` cap. Bytes decode with OpenCV
where it is installed, else PIL.
"""

from __future__ import annotations

import io
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Optional

import numpy as np


def decode_image_bytes(data: bytes) -> Optional[np.ndarray]:
    """JPEG/PNG bytes -> uint8 RGB HWC array, None on failure."""
    try:
        import cv2

        arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if arr is None:
            raise ValueError("cv2 decode failed")
        return arr[:, :, ::-1].copy()  # BGR -> RGB
    except Exception:
        try:
            from PIL import Image

            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        except Exception:
            return None


def load_image(path_or_url: str, timeout: float = 30.0):
    """Path or URL -> PIL RGB image, None on failure (reference main.py:121-128)."""
    from PIL import Image

    try:
        if path_or_url.startswith("http"):
            import requests

            r = requests.get(path_or_url, timeout=timeout)
            r.raise_for_status()
            return Image.open(io.BytesIO(r.content)).convert("RGB")
        return Image.open(path_or_url).convert("RGB")
    except Exception:
        return None


def load_images_from_csv(csv_path: str, max_images: Optional[int] = None) -> List[Dict[str, Any]]:
    """CSV with ``offer_id, seq, url`` columns (reference main.py:131-143)."""
    try:
        import pandas as pd

        df = pd.read_csv(csv_path)
        images = []
        for _, row in df.iterrows():
            images.append({
                "offer_id": row.get("offer_id", ""),
                "seq": row.get("seq", ""),
                "url": row["url"],
            })
            if max_images and len(images) >= max_images:
                break
        return images
    except Exception:
        return []


def load_many(paths: Iterable[str], max_workers: int = 4):
    """Concurrently load a list of paths/URLs; yields (path, image-or-None) in
    order (reference main.py:344-346 uses ThreadPoolExecutor(4))."""
    paths = list(paths)
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        results = list(pool.map(load_image, paths))
    return list(zip(paths, results))
