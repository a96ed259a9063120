"""The harness on the CPU at the tiny size: lookup by name, the result line,
the import check, the comparison against the reference, and the faults that
must turn ``correct`` false. Run from the repository root:

    python3 -m pytest h100_bench/tests -q
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from h100_bench import generator, harness
from h100_bench.tests import tiny

BENCH = harness.load_benchmark(tiny.ROOT)
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
TRAIN_FP32 = {"dtype": "float32", "attn_impl": "xla", "rank": 4, "alpha": 8, "lr": 1e-3,
              "weight_decay": 0.01, "grad_clip": 1.0}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_benchmark_file_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert layers == {"batcher", "engine dispatch/fetch", "model step", "kernels", "device"}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_resolves_by_name(workload):
    w, cfg, traffic = harness.cell(BENCH, tiny.ROOT, workload)
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith("h100_bench/") and cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"] and entry["reduced"] == []
    runner = generator.load_kind(traffic["kind"]).Runner
    assert all(callable(getattr(runner, f)) for f in ("setup", "window", "finish", "compare"))
    e2e = harness.metrics_for(BENCH, "end_to_end", workload)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = harness.metrics_for(BENCH, "per_layer", workload, {m["name"] for m in e2e})
    assert layer
    for m in layer:
        assert callable(harness.reader(m["name"]))
    for k, v in cfg["limits"][traffic["kind"]].items():
        assert v is not None and v > 0, k


def test_every_metric_has_its_reader():
    files = {p.stem for p in (tiny.ROOT / "h100_bench" / "metrics").glob("*.py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(workload, trace):
    code, res = tiny.run(workload, trace=trace)
    assert code == 0
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        keys.append("breakdown")
    assert list(res) == keys + ["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    wanted = harness.metrics_for(BENCH, "end_to_end", workload)
    if trace:
        wanted = harness.metrics_for(BENCH, "per_layer", workload, {m["name"] for m in wanted})
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert len(res["breakdown"]["idle_gaps"]) <= 10
    got = res["metrics"]
    for m in wanted:
        if trace and m["source"] == "device_trace" and "idle_share" not in m["name"]:
            continue  # no device kernels on the CPU
        assert got[m["name"]]["unit"] == m["unit"]
        assert np.isfinite(got[m["name"]]["value"])
    for c in res["compared"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_import_check_compares_whole_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "aiic_tpu_torch_lookalike", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    for name in ("jax", "jaxlib.xla_client", "flax", "aiic_tpu", "aiic_tpu.engine"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == ["aiic_tpu", "flax", "jax", "jaxlib"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    code, res = harness.run(["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1"],
                            log=lambda m: None)
    assert code != 0 and res is None


def test_reference_imports_nothing_of_the_program():
    src = (tiny.ROOT / "h100_bench" / "reference" / "clip_ref.py").read_text()
    imports = re.findall(r"^\s*(?:from|import)\s+([A-Za-z0-9_]+)", src, re.M)
    assert set(imports) <= {"__future__", "html", "unicodedata", "typing", "numpy", "torch",
                            "regex"}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct_at_the_tiny_size(workload):
    code, res = tiny.run(workload, cfg=dict(tiny.FP32, train=TRAIN_FP32, limits=tiny.LIMITS))
    assert code == 0 and res["correct"], res["compared"]


# ---------------------------------------------------------------------------
# faults underneath the timed path: each must turn ``correct`` false
# ---------------------------------------------------------------------------


def _broken_classify(monkeypatch):
    from aiic_tpu_torch.engine import analyzer, programs

    real = programs.classify_batch

    def altered(*a, **k):
        out = real(*a, **k)
        # answers altered where they are produced: the top-k reversed, the
        # interior mass halved, each row's features handed to its neighbour
        out["topk_idx"] = out["topk_idx"].flip(-1)
        out["interior_mass"] = out["interior_mass"] * 0.5
        out["features"] = out["features"].roll(1, 0)
        return out

    monkeypatch.setattr(analyzer, "classify_batch", altered)


@pytest.mark.parametrize("workload", ["b16-bf16-offline", "l14-int8-offline",
                                      "b16-bf16-serve-closed"])
@pytest.mark.parametrize("limits", ["tiny", "cell"])
def test_altered_answer_fails(monkeypatch, workload, limits):
    """Each cell's own compared numbers (the cell's limits) fail an altered
    answer, and so does every number at the tiny size's limits."""
    _broken_classify(monkeypatch)
    cfg = dict(tiny.FP32)
    if limits == "tiny":
        cfg["limits"] = tiny.LIMITS
    code, res = tiny.run(workload, cfg=cfg)
    assert code == 0 and not res["correct"]


@pytest.mark.parametrize("limits", ["tiny", "cell"])
def test_misrouted_answer_fails(monkeypatch, limits):
    """The batcher hands each future its neighbour's answer: the features
    that ride with the answer reach the wrong request, and the comparison
    against the reference on the request's own crop fails."""
    from aiic_tpu_torch.serve import batcher

    real = batcher.DynamicBatcher._resolve

    def rolled(self, futures, results):
        results = list(results)
        return real(self, futures, results[1:] + results[:1])

    monkeypatch.setattr(batcher.DynamicBatcher, "_resolve", rolled)
    cfg = dict(tiny.FP32)
    if limits == "tiny":
        cfg["limits"] = tiny.LIMITS
    code, res = tiny.run("b16-bf16-serve-closed", cfg=cfg)
    assert code == 0 and not res["correct"]


def test_unchanged_state_fails(monkeypatch):
    from aiic_tpu_torch.train import trainer

    real = trainer.make_train_step

    def frozen(*a, **k):
        step, ev = real(*a, **k)

        def same(params, lora, opt, x, tokens, generator=None):
            loss, _, new_opt = step(params, lora, opt, x, tokens, generator)
            return loss, lora, new_opt  # the adapters come back unchanged

        same.__dict__.update(step.__dict__)
        return same, ev

    monkeypatch.setattr(trainer, "make_train_step", frozen)
    code, res = tiny.run("b16-bf16-train", cfg=dict(train=TRAIN_FP32, limits=tiny.LIMITS))
    assert code == 0 and not res["correct"]
    assert res["compared"]["change_gap"]["value"] > 0.5


def test_half_batch_fails(monkeypatch):
    from aiic_tpu_torch.train import trainer

    real = trainer.make_train_step

    def halved(*a, **k):
        step, ev = real(*a, **k)

        def half(params, lora, opt, x, tokens, generator=None):
            n = x.shape[0] // 2  # half of the batch left out, the mean over the rest
            return step(params, lora, opt, x[:n], tokens[:n], generator)

        half.__dict__.update(step.__dict__)
        return half, ev

    monkeypatch.setattr(trainer, "make_train_step", halved)
    code, res = tiny.run("b16-bf16-train", cfg=dict(train=TRAIN_FP32, limits=tiny.LIMITS))
    assert code == 0 and not res["correct"]


# ---------------------------------------------------------------------------
# the controls
# ---------------------------------------------------------------------------


def test_int4_reference_control_fails_the_l14_limits():
    cfg = json.loads((tiny.ROOT / "h100_bench/configs/clip-vit-l14-int8.json").read_text())
    code, res = tiny.run("l14-int8-offline", control="reference",
                         cfg={"limits": cfg["limits"]})
    assert code == 0 and not res["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,control", [("b16-bf16-offline", "reference"),
                                              ("b16-bf16-serve-closed", "reference"),
                                              ("l14-int8-offline", "reference"),
                                              ("b16-bf16-train", "train")])
def test_control_fails_at_the_cell_size(workload, control):
    """On the card: the control in the program's place, at the cell's own
    size, on three seeds, fails the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (2147483901, 2147483902, 2147483903):
        code, res = harness.run(["--workload", workload, "--seed", str(seed), "--seconds", "3"],
                                control=control, log=lambda m: None)
        assert code == 0 and not res["correct"], res["compared"]


# ---------------------------------------------------------------------------
# a cell, a mix, a kind of traffic and a metric added as files and entries alone
# ---------------------------------------------------------------------------

NEW_KIND = '''"""``offline_sync``: the offline calls with none dispatched ahead."""

from h100_bench import generator


class Runner(generator.load_kind("offline").Runner):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.ahead = 0
'''


def test_new_cell_mix_kind_and_metric_are_files(tmp_path):
    shutil.copytree(tiny.ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((tmp_path / "h100_bench/configs/clip-vit-b16-bf16.json").read_text())
    cfg["name"] = "clip-vit-b32-bf16"
    (tmp_path / "h100_bench/configs/clip-vit-b32-bf16.json").write_text(json.dumps(cfg))
    mix = json.loads((tmp_path / "h100_bench/traffic/offline.json").read_text())
    mix.update(kind="offline_sync", limits="offline", batch=4)
    (tmp_path / "h100_bench/traffic/offline_small.json").write_text(json.dumps(mix))
    (tmp_path / "h100_bench/kinds/offline_sync.py").write_text(NEW_KIND)
    (tmp_path / "h100_bench/metrics/calls.offline_small.py").write_text(
        "def read(run):\n    return float(len(run.traced_calls))\n")
    bench["configs"].append({**bench["configs"][0], "name": "clip-vit-b32-bf16",
                             "file": "h100_bench/configs/clip-vit-b32-bf16.json"})
    bench["workloads"].append({"name": "b32-small", "config": "clip-vit-b32-bf16",
                               "traffic": "offline_small", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "calls.offline_small", "unit": "calls",
                               "better": "higher", "source": "program_counter",
                               "layer": "engine dispatch/fetch", "moves": "images_per_s",
                               "workloads": ["b32-small"]})
    for m in bench["end_to_end"]:
        if m["name"] == "images_per_s":
            m["workloads"].append("b32-small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys\n"
        "from h100_bench.tests import tiny\n"
        "from pathlib import Path\n"
        "tiny.TRAFFIC['offline_sync'] = {'pool': 16, 'check_rows': 4}\n"
        "c, r = tiny.run('b32-small', trace=1, root=Path.cwd(),\n"
        "                cfg=dict(tiny.FP32, limits=tiny.LIMITS))\n"
        "print(json.dumps(r))\n")
    env = {"PYTHONPATH": f"{tmp_path}:{tiny.ROOT}", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metrics"]["calls.offline_small"]["value"] >= 1
    assert res["attempted"] > 0 and res["correct"], res["compared"]
