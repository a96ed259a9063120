"""The port's measurement tools (``tools/torch_{bench,serve_bench,rest_bench,
e2e_bench,train_bench,train_e2e_bench}.py``) at TINY_TEST on the CPU, each
called in process through ``main(argv)`` on the synthetic reference tree of
``tests/torch_reference.py``.

Each record's keys, in order, are its JAX twin's. The JAX tools are neither
imported nor run here: their key lists are pinned below with the source
lines they come from, and ``ast`` checks that every pinned key is a string
constant of that tool's source, so a pinned list cannot drift from the file.
"""

import ast
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from torch_reference import N_IMAGES, make_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = ("bench", "serve_bench", "rest_bench", "e2e_bench", "train_bench", "train_e2e_bench")

# Record keys of the JAX tools, in the order they print them.
REST_POINT = ["tag", "clients", "requests", "errors", "qps", "p50_ms", "p95_ms", "p99_ms",
              "avg_batch"]  # tools/rest_bench.py:148-158 (summarize)
JAX_KEYS = {
    # bench.py:214-221
    "bench": ("bench.py", ["metric", "value", "unit", "vs_baseline", "p50_ms",
                           "p50_device_ms"]),
    # tools/serve_bench.py:139-151; no completions :133-134
    "serve_bench": ("tools/serve_bench.py", [
        "metric", "value", "p90_ms", "p99_ms", "qps", "kind", "load", "requests", "errors",
        "pipeline_depth", "avg_batch"]),
    "serve_bench_empty": ("tools/serve_bench.py", ["kind", "load", "errors", "error"]),
    # tools/rest_bench.py summarize (:148-158) and the extras of each load point
    # (:298-299, :351-354, :380-383); the final line :409-417
    "rest_bench_point": ("tools/rest_bench.py", REST_POINT + ["max_wait_ms",
                                                             "pipeline_depth"]),
    "rest_bench_urls": ("tools/rest_bench.py", REST_POINT + [
        "images_per_request", "corpus", "img_per_s", "max_wait_ms", "pipeline_depth"]),
    "rest_bench_batch": ("tools/rest_bench.py", REST_POINT + [
        "images_per_request", "img_per_s", "max_wait_ms", "pipeline_depth"]),
    "rest_bench_final": ("tools/rest_bench.py", ["metric", "value", "unit", "best_point",
                                                 "batch_img_per_s", "best_batch_point"]),
    # tools/e2e_bench.py:100-107
    "e2e_bench": ("tools/e2e_bench.py", ["metric", "value", "unit", "images", "seconds",
                                         "stage_seconds"]),
    # tools/train_bench.py:117-129 (cached_features, prompt_pool, model where set)
    "train_bench": ("tools/train_bench.py", ["metric", "value", "unit", "batch", "final_loss",
                                             "cached_features", "prompt_pool", "model"]),
    # tools/train_e2e_bench.py:78-89
    "train_e2e_bench": ("tools/train_e2e_bench.py", [
        "metric", "value", "unit", "epoch_seconds_steady", "setup_seconds", "n_items", "batch",
        "epochs", "wall_seconds", "best_val_loss"]),
}


def _twin(name: str):
    path = os.path.join(REPO, "tools", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys(name: str, *, without=()) -> list:
    return [k for k in JAX_KEYS[name][1] if k not in without]


def _rates_ok(rec: dict, *keys) -> None:
    for k in keys:
        assert math.isfinite(rec[k]) and rec[k] > 0, (k, rec)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return make_reference(tmp_path_factory.mktemp("reference"))


@pytest.mark.parametrize("name", sorted(JAX_KEYS))
def test_pinned_keys_are_in_the_jax_tool(name):
    path, keys = JAX_KEYS[name]
    with open(os.path.join(REPO, path), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    strings = {n.value for n in ast.walk(tree)
               if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert [k for k in keys if k not in strings] == []


@pytest.mark.parametrize("int8,wire", [("2", "patch"), ("1", "patch"), ("0", "hwc")])
def test_bench_record(monkeypatch, int8, wire):
    monkeypatch.setenv("AIIC_BENCH_MODEL", "tiny")
    monkeypatch.setenv("AIIC_BENCH_INT8", int8)
    monkeypatch.setenv("AIIC_WIRE", wire)
    (rec,) = _twin("bench").main(["8", "2", "--device", "cpu"])
    assert list(rec) == _keys("bench")
    assert rec["metric"] == "images_per_sec_per_chip" and rec["unit"] == "img/s"
    _rates_ok(rec, "value", "p50_ms")
    assert rec["vs_baseline"] == round(rec["value"] / 5000, 4)
    assert 0 <= rec["p50_device_ms"] <= rec["p50_ms"]


def test_bench_program_rows_are_independent():
    """The program ``torch_bench`` times: the first rows of a batch give the
    rows of a smaller batch on their own (the check chip_smoke.py makes at
    B=4096 against B=256 on the card)."""
    tool = _twin("bench")
    bench = tool.setup("tiny", "2", "patch", torch.device("cpu"), np.random.default_rng(0))
    px = torch.from_numpy(bench["make_batch"](16))
    big, _ = bench["classify"](px)
    small, _ = bench["classify"](px[:4])
    got = tool.row_agreement(big, small)
    assert got["ok"] and (got["rows"], got["of"]) == (4, 16), got
    # a changed row is seen
    moved = dict(small, topk_idx=small["topk_idx"].flip(-1))
    assert not tool.row_agreement(big, moved)["ok"]


def test_serve_bench_closed_loop_batches():
    (rec,) = _twin("serve_bench").main(["--model", "tiny", "--device", "cpu", "--clients", "16",
                                        "--per-client", "4"])
    assert list(rec) == _keys("serve_bench")
    assert rec["kind"] == "closed" and rec["requests"] == 64 and rec["errors"] == 0
    assert rec["avg_batch"] > 1
    _rates_ok(rec, "value", "qps")


def test_serve_bench_open_loop_counts_its_requests():
    (rec,) = _twin("serve_bench").main(["--model", "tiny", "--device", "cpu", "--open-rates",
                                        "40", "--open-seconds", "1"])
    assert list(rec) == _keys("serve_bench")
    assert (rec["kind"], rec["load"], rec["requests"], rec["errors"]) == ("open", 40.0, 40, 0)
    # a completion's latency ends at its future, not when the pacer is done
    assert rec["value"] < 500
    _rates_ok(rec, "value", "qps")


def test_rest_bench_records(reference, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    recs = _twin("rest_bench").main([
        "--model", "tiny", "--device", "cpu", "--reference", str(reference), "--clients", "1,4",
        "--per-client", "3", "--batch-images", "4", "--batch-urls", "2"])
    tags = [r["tag"] for r in recs[:-1]]
    assert tags == ["c1", "c4", "urls2_c1", "urls2_c4", "batch4_c1", "batch4_c4"]
    for rec in recs[:-1]:
        kind = {"c": "rest_bench_point", "u": "rest_bench_urls",
                "b": "rest_bench_batch"}[rec["tag"][0]]
        assert list(rec) == _keys(kind), rec
        assert rec["errors"] == 0 and rec["requests"] == rec["clients"] * (
            3 if kind == "rest_bench_point" else 1 + (kind == "rest_bench_urls"))
        _rates_ok(rec, "qps", "p50_ms", *(["img_per_s"] if "img_per_s" in rec else []))
    final = recs[-1]
    assert list(final) == _keys("rest_bench_final")
    assert final["best_point"]["tag"] in ("c1", "c4")
    assert final["batch_img_per_s"] == max(r.get("img_per_s", 0) for r in recs[:-1])
    assert not os.path.exists(tmp_path / ".aiic_cache")  # no text cache kept


def test_rest_bench_synthetic_payloads_without_images(tmp_path, monkeypatch):
    """No ``dataset_images/``: the JAX tool's 8 synthetic JPEGs, no URL
    points, and a final line without the batch keys."""
    monkeypatch.chdir(tmp_path)
    recs = _twin("rest_bench").main([
        "--model", "tiny", "--device", "cpu", "--reference", str(tmp_path), "--clients", "2",
        "--per-client", "2", "--batch-urls", "2"])
    assert [r.get("tag") for r in recs] == ["c2", None]
    assert list(recs[-1]) == _keys("rest_bench_final", without=("batch_img_per_s",
                                                                "best_batch_point"))
    assert recs[0]["requests"] == 4 and recs[0]["errors"] == 0


@pytest.mark.parametrize("mode", ["stream", "url", "fast"])
def test_e2e_bench_counts_path_occurrences(reference, mode):
    (rec,) = _twin("e2e_bench").main(["2", "8", mode, "--model", "tiny", "--device", "cpu",
                                      "--reference", str(reference)])
    assert list(rec) == _keys("e2e_bench")
    assert rec["metric"] == f"e2e_jpeg_to_verdict_images_per_sec_{mode}"
    assert rec["images"] == 2 * N_IMAGES
    assert {"dispatch", "fetch"} <= set(rec["stage_seconds"])
    _rates_ok(rec, "value")


def _direct_final_loss(batch: int, iters: int, flags: list) -> float:
    """make_train_step called directly on the tool's seeds (the weights
    from seed 0 cast to bf16, the adapters from seed 1, the batch from
    ``np.random.default_rng(0)``), ``iters + 1`` steps."""
    from aiic_tpu_torch.adapters import LoRAConfig, init_text_lora
    from aiic_tpu_torch.models.config import TINY_TEST as cfg
    from aiic_tpu_torch.models.init import init_clip_params, tree_map
    from aiic_tpu_torch.ops.quant import quantize_model_mlp
    from aiic_tpu_torch.train.trainer import TrainConfig, make_optimizer, make_train_step

    text8, pool = "text8" in flags, 64 if "dedup" in flags else 0
    cached = "cached" in flags or bool(pool)
    tcfg = TrainConfig(epochs=1, batch_size=batch, rank=16, alpha=32, dtype=torch.bfloat16,
                       quantize_text=text8,
                       attn_impl="block_fused" if ("block" in flags or text8) else "auto")
    params = tree_map(lambda t: t.to(torch.bfloat16),
                      init_clip_params(cfg, torch.Generator().manual_seed(0)))
    if text8:
        params = quantize_model_mlp(params, attn=True, towers=("text",))
    lora = init_text_lora(torch.Generator().manual_seed(1), cfg, LoRAConfig(16, 32, tcfg.attach),
                          device="cpu")
    opt = make_optimizer(tcfg, steps_per_epoch=100)
    state = opt.init(lora)
    rng = np.random.default_rng(0)

    def rows(n):
        t = rng.integers(1, cfg.vocab_size - 3, (n, cfg.context_length)).astype(np.int32)
        t[:, 0], t[:, -1] = cfg.vocab_size - 2, cfg.vocab_size - 1
        return t

    prompt_pool = rows(pool) if pool else None
    step, _ = make_train_step(cfg, tcfg, opt, cached_image=cached, prompt_pool=prompt_pool,
                              device="cpu")
    x = torch.from_numpy(rng.standard_normal((batch, cfg.image_size, cfg.image_size, 3))
                         .astype(np.float32)).to(torch.bfloat16)
    if cached:
        x = step.image_features(params, x)
    tokens = torch.from_numpy(rng.integers(0, pool, (batch,)).astype(np.int32) if pool
                              else rows(batch))
    for _ in range(iters + 1):
        loss, lora, state = step(params, lora, state, x, tokens)
    return float(loss)


@pytest.mark.parametrize("flags", [[], ["block"], ["text8", "cached", "dedup"]],
                         ids=["auto", "block", "text8_cached_dedup"])
def test_train_bench_final_loss_is_the_steps(flags):
    (rec,) = _twin("train_bench").main(["8", "2", *flags, "model=tiny", "--device", "cpu"])
    extra = ([] if "cached" in flags else ["cached_features"]) + (
        [] if "dedup" in flags else ["prompt_pool"])
    assert list(rec) == _keys("train_bench", without=extra)
    assert rec["batch"] == 8 and rec["model"] == "tiny-test"
    assert rec.get("prompt_pool", 64) == 64
    _rates_ok(rec, "value")
    assert rec["final_loss"] == pytest.approx(round(_direct_final_loss(8, 2, flags), 4),
                                              rel=1e-6)


def test_train_e2e_bench_best_val_loss_is_train_lora(reference, tmp_path):
    from aiic_tpu_torch.data.dataset import load_training_data
    from aiic_tpu_torch.models.config import TINY_TEST
    from aiic_tpu_torch.train import TrainConfig, train_lora

    (rec,) = _twin("train_e2e_bench").main(["48", "16", "2", "--model", "tiny", "--device",
                                            "cpu", "--reference", str(reference)])
    assert list(rec) == _keys("train_e2e_bench")
    assert (rec["n_items"], rec["batch"], rec["epochs"]) == (48, 16, 2)
    _rates_ok(rec, "value", "epoch_seconds_steady", "wall_seconds")

    items = load_training_data(str(reference / "interior_dataset.json"))
    path = tmp_path / "ds.json"
    path.write_text(json.dumps({"training_data": [items[i % len(items)] for i in range(48)]}),
                    encoding="utf-8")
    out = train_lora(str(path), str(tmp_path / "demo.pth"),
                     cfg=TrainConfig(epochs=2, batch_size=16, rank=16, alpha=32,
                                     dtype=torch.bfloat16),
                     config=TINY_TEST, image_root=str(reference), log=lambda _m: None,
                     device="cpu")
    assert rec["best_val_loss"] == round(out["best_val_loss"], 4)


REFUSALS = {
    "bench": ["8", "2"],
    "serve_bench": ["--model", "tiny"],
    "rest_bench": ["--model", "tiny"],
    "e2e_bench": ["1", "8", "stream", "--model", "tiny"],
    "train_bench": ["8", "2", "model=tiny"],
    "train_e2e_bench": ["16", "8", "1", "--model", "tiny"],
}


@pytest.mark.parametrize("name", TWINS)
def test_twin_refuses_without_a_card(name, monkeypatch, capsys):
    """No card and no ``--device cpu``: the twin exits and says why, before
    it builds anything; ``AIIC_PLATFORM`` unset, so its default is cuda."""
    monkeypatch.delenv("AIIC_PLATFORM", raising=False)
    monkeypatch.setenv("AIIC_BENCH_MODEL", "tiny")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device is visible"):
        _twin(name).main(REFUSALS[name])
    assert capsys.readouterr().out == ""  # no record printed


def test_chip_smoke_holds_the_pinned_keys():
    """``chip_smoke.py`` phase 17 holds the card's records to these pins."""
    import chip_smoke

    assert chip_smoke.TWIN_KEYS == {k: JAX_KEYS[k][1] for k in chip_smoke.TWIN_KEYS}
    assert set(chip_smoke.TWIN_KEYS) <= set(JAX_KEYS)
