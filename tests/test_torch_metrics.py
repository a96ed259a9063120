"""The port's attribute-F1 (``aiic_tpu_torch.train.metrics``) and its tool
twin against the JAX package.

- Stub analyzers (tests/test_metrics.py's two cases, and a missing result,
  an empty true set, six true labels so that k = min(5, |true|) = 5, an
  ``image_root`` other than "."): both packages' ``attribute_f1`` give equal
  dicts, and the stated scores.
- The port's ``InteriorAnalyzer(device="cpu")`` against JAX's at TINY_TEST on
  the same weights (the fp32 default engines, ``"auto"`` being ``"xla"`` on
  the CPU in both) over 6 generated labelled PNGs: equal dicts.
- ``tools/torch_eval_f1.py --device cpu`` as a process on 2 generated images
  at ViT-B/16: its JSON equals the in-process call on the engine the tool
  builds (the same weights, fp32, the dataset's vocabulary).
"""

import json
import os
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from aiic_tpu.engine import InteriorAnalyzer as JaxAnalyzer
from aiic_tpu.models.config import TINY_TEST as JAX_TINY
from aiic_tpu.models.init import flatten_params, init_clip_params
from aiic_tpu.train.metrics import attribute_f1 as jax_attribute_f1
from aiic_tpu_torch.engine import InteriorAnalyzer
from aiic_tpu_torch.models.config import TINY_TEST
from aiic_tpu_torch.models.init import params_from_numpy
from aiic_tpu_torch.train.metrics import attribute_f1

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class StubAnalyzer:
    category_names = ["styles", "characteristics", "materials", "room_types"]

    def __init__(self, results):
        self._results = results

    def analyze_images_batch(self, paths, filter_interiors=False):
        assert not filter_interiors
        return self._results


def _item(path, style="boho", chars=("x", "y"), room="salon", materials=()):
    return {"image_path": path, "style": style, "characteristics": list(chars),
            "materials": list(materials), "colors": [], "room_type": room}


def _result(styles, chars, rooms, materials=()):
    return {"is_interior": True, "analysis": {
        "styles": [(a, 0.5) for a in styles], "characteristics": [(a, 0.5) for a in chars],
        "materials": [(a, 0.5) for a in materials], "room_types": [(a, 0.5) for a in rooms]}}


SIX = ["a", "b", "c", "d", "e", "f"]
# case -> (training data, image root, {path relative to the root: result}, expected scores)
CASES = {
    "perfect": ([_item("a.jpg")], ".",
                {"a.jpg": _result(["boho", "retro"], ["x", "y", "z"], ["salon"])},
                {"styles": 1.0, "characteristics": 1.0, "room_types": 1.0}),
    "wrong": ([_item("a.jpg", chars=["x"])], ".",
              {"a.jpg": _result(["retro"], ["q"], ["kuchnia"])},
              {"styles": 0.0, "characteristics": 0.0, "room_types": 0.0}),
    "missing_result": ([_item("a.jpg"), _item("b.jpg", style="retro")], ".",
                       {"a.jpg": _result(["boho"], ["x", "q"], ["salon"])},
                       {"styles": 1.0, "characteristics": 0.5, "room_types": 1.0}),
    "empty_true_set": ([_item("a.jpg", style="", chars=[], room=""), _item("b.jpg")], ".",
                       {"a.jpg": _result(["retro"], ["q"], ["kuchnia"]),
                        "b.jpg": _result(["boho"], ["y", "x"], ["salon"])},
                       {"styles": 1.0, "characteristics": 1.0, "room_types": 1.0}),
    # six true labels: k = 5, so the top-5 of seven predictions score 5 of 6
    "six_true_labels": ([_item("a.jpg", chars=SIX, materials=["drewno"])], ".",
                        {"a.jpg": _result(["boho"], SIX[:4] + ["q"] + SIX[4:], ["salon"],
                                          ["marmur", "drewno"])},
                        {"characteristics": 2 * (4 / 5) * (4 / 6) / (4 / 5 + 4 / 6),
                         "materials": 0.0}),
    "image_root": ([_item("a.jpg"), _item("sub/b.jpg", style="retro")], "imgs",
                   {"a.jpg": _result(["boho"], ["x", "y"], ["salon"]),
                    "sub/b.jpg": _result(["boho"], ["x"], ["kuchnia"])},
                   {"styles": 0.5, "room_types": 0.5}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_attribute_f1_on_stubs_matches_jax(case):
    data, root, rel, want = CASES[case]
    results = {os.path.join(root, p): r for p, r in rel.items()}
    got = attribute_f1(StubAnalyzer(results), data, root)
    assert got == jax_attribute_f1(StubAnalyzer(results), data, root)
    assert set(got) == set(StubAnalyzer.category_names)
    for cat, f1 in want.items():
        assert got[cat]["f1"] == pytest.approx(f1, abs=1e-12), (cat, got[cat])
    if case == "six_true_labels":
        assert got["characteristics"]["n"] == 6  # tp 4 + fn 2
    if case == "missing_result":
        assert got["styles"]["n"] == 1  # the image without a result is not scored


# Labels drawn from tests/test_engine.py's vocabulary (the first two items
# are its own, so that the engines' vocabulary is the same).
VOCAB = {"style": ["nowoczesny", "klasyczny"],
         "characteristics": ["czyste linie", "przestronne", "eleganckie"],
         "materials": ["drewno", "marmur"], "colors": ["biały", "szary", "beżowy"],
         "room_type": ["kuchnia", "salon"]}


def _labelled_images(root, n, size_range, seed):
    """n generated PNGs under ``root/images`` and their labelled items."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    items = []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(*size_range, 2))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, "images", f"im{i}.png"))
        pick = lambda key, k: [str(v) for v in rng.choice(VOCAB[key], k, replace=False)]  # noqa: E731
        items.append({"image_path": f"images/im{i}.png", "style": pick("style", 1)[0],
                      "characteristics": pick("characteristics", int(rng.integers(1, 4))),
                      "materials": pick("materials", int(rng.integers(0, 3))),
                      "colors": pick("colors", int(rng.integers(1, 4))),
                      "room_type": pick("room_type", 1)[0]})
    items[0].update(style="nowoczesny", characteristics=["czyste linie", "przestronne"],
                    materials=["drewno"], colors=["biały", "szary"], room_type="kuchnia")
    items[1].update(style="klasyczny", characteristics=["eleganckie"], materials=["marmur"],
                    colors=["beżowy"], room_type="salon")
    return items


def test_tiny_engines_attribute_f1_matches_jax(tmp_path):
    items = _labelled_images(str(tmp_path), 6, (30, 60), seed=5)
    jp = init_clip_params(jax.random.PRNGKey(0), JAX_TINY)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # real-weights-with-hermetic-tokenizer notice
        ref = JaxAnalyzer(jp, JAX_TINY, training_data=items)
        ours = InteriorAnalyzer(params_from_numpy(flatten_params(jp)), TINY_TEST,
                                training_data=items, device="cpu")
    assert ours.category_names == ref.category_names
    got = attribute_f1(ours, items, str(tmp_path))
    want = jax_attribute_f1(ref, items, str(tmp_path))
    assert got == want
    assert set(got) == {"styles", "characteristics", "materials", "colors", "room_types"}
    assert got["styles"]["n"] == got["room_types"]["n"] == 6


def test_eval_f1_twin_process_matches_in_process(tmp_path):
    from aiic_tpu_torch.data.dataset import load_training_data
    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.models.init import (
        init_clip_params as port_init, load_clip_weights, save_clip_weights,
    )

    items = _labelled_images(str(tmp_path), 3, (224, 260), seed=6)
    ds = tmp_path / "interior_dataset.json"
    ds.write_text(json.dumps({"training_data": items}, ensure_ascii=False), encoding="utf-8")
    weights = str(tmp_path / "weights.npz")
    save_clip_weights(port_init(VIT_B_16, torch.Generator().manual_seed(0), device="cpu"),
                      weights)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_eval_f1.py"), "--dataset-json",
         str(ds), "--weights", weights, "--limit", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    printed = json.loads(proc.stdout)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        engine = InteriorAnalyzer(load_clip_weights(weights, VIT_B_16), VIT_B_16,
                                  training_data=load_training_data(str(ds)), device="cpu")
    assert printed == attribute_f1(engine, items[:2], str(tmp_path))
    assert printed["styles"]["n"] == 2

    # without a card and without --device cpu the tool refuses to run
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "torch_eval_f1.py"),
                           "--dataset-json", str(ds)],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and "no CUDA device is visible" in proc.stderr
