"""The port's CLIs against the JAX package's: the parsers (the same flags and
defaults for the same argv, plus ``--device``), the shared ``EngineArgs``
(text-cache fingerprints apart per package, ``--mesh-devices`` on a world of
one, the worker over a world of two processes: SIGTERM, a dead follower; no
CUDA fallback to the CPU), and the batch and worker entry points end to end
with ``--device cpu`` against the JAX package on the same weights file.

Bars: the records' verdicts, categories, reasons, top-k names and DB
documents equal; confidences within 1e-5 (fp32 on the CPU in both).
"""

import json
import signal
import warnings

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from aiic_tpu.cli import common as jax_common
from aiic_tpu.cli import main as jax_main
from aiic_tpu.cli import worker as jax_cli_worker
from aiic_tpu.models.config import TINY_TEST as JAX_TINY
from aiic_tpu.models.init import init_clip_params, save_clip_weights
from aiic_tpu.serve import db as jax_db
from aiic_tpu.serve import worker as jax_worker
from aiic_tpu_torch.cli import common, main as cli_main, worker as cli_worker
from aiic_tpu_torch.serve import db

TOL = 1e-5
TRAINING = [
    {"image_path": "a.jpg", "style": "nowoczesny", "characteristics": ["jasne"],
     "materials": ["drewno"], "colors": ["biały"], "room_type": "kuchnia"},
    {"image_path": "b.jpg", "style": "klasyczny", "characteristics": ["ciemne"],
     "materials": ["marmur"], "colors": ["czarny"], "room_type": "salon"},
]

WORKER_ARGV = [
    [],
    ["--serve", "--quantize", "--dtype", "bfloat16", "--wire-format", "patch", "--port", "8123"],
    ["--max-apartments", "3", "--batch-size", "4", "--use-lora", "--lora-weights", "a.pth",
     "--lora-rank", "16", "--text-cache", "none", "--model", "tiny"],
    ["--export-only", "--seed-demo", "--max-queue", "0", "--pipeline-depth", "0",
     "--mesh-devices", "2", "--fast-decode"],
]
MAIN_ARGV = [
    [],
    ["--analyze-csv", "x.csv", "--use-lora", "--no-filter-interiors", "--max-images", "5",
     "--batch-size", "4", "--confidence-threshold", "0.5", "--output", "o.json"],
    ["--dtype", "bfloat16", "--quantize", "--weights", "w.npz", "--dataset-json", "d.json"],
]


@pytest.fixture(autouse=True)
def _keep_sigterm():
    """``cli.worker.main`` turns SIGTERM into SystemExit for its process;
    the test process gets its own handler back."""
    before = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, before)


@pytest.mark.parametrize("argv", WORKER_ARGV, ids=["defaults", "serve_int8", "drain", "misc"])
def test_worker_parser_matches_jax(argv):
    ours = vars(cli_worker.build_parser().parse_args(argv))
    ref = vars(jax_cli_worker.build_parser().parse_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == ref


@pytest.mark.parametrize("argv", MAIN_ARGV, ids=["defaults", "reference_flags", "engine"])
def test_main_parser_matches_jax(argv):
    ours = vars(cli_main.build_parser().parse_args(argv))
    ref = vars(jax_main.build_parser().parse_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == ref
    assert vars(cli_main.build_parser().parse_args(argv + ["--device", "cpu"]))["device"] == "cpu"


def test_engine_args_fields_and_flags_match_jax():
    import dataclasses

    ours = {f.name: f.default for f in dataclasses.fields(common.EngineArgs)}
    ref = {f.name: f.default for f in dataclasses.fields(jax_common.EngineArgs)}
    assert ours.pop("device") == "cuda"
    assert ours == ref
    assert common.model_presets().keys() == jax_common.model_presets().keys()
    for parser, jparser in ((cli_worker.build_parser(), jax_cli_worker.build_parser()),
                            (cli_main.build_parser(), jax_main.build_parser())):
        flags = {s for a in parser._actions for s in a.option_strings}
        jflags = {s for a in jparser._actions for s in a.option_strings}
        assert flags == jflags | {"--device"}


def test_auto_text_cache_paths_differ_from_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ds = tmp_path / "ds.json"
    ds.write_text(json.dumps({"training_data": TRAINING}), encoding="utf-8")
    kw = dict(dataset_json=str(ds), dtype="bfloat16")
    ours = common.EngineArgs(**kw).text_cache_path(None, 4, 8)
    ref = jax_common.EngineArgs(**kw).text_cache_path(None, 4, 8)
    assert ours.startswith(".aiic_cache/textcache_") and ref.startswith(".aiic_cache/textcache_")
    assert ours != ref
    assert common.EngineArgs(**kw).text_cache_path(None, 4, 8) == ours  # deterministic
    assert common.EngineArgs(**kw, device="cpu").text_cache_path(None, 4, 8) != ours
    assert common.EngineArgs(**kw, quantize=True).text_cache_path(None, 4, 8) != ours
    assert common.EngineArgs(**kw, text_cache="none").text_cache_path(None, 4, 8) is None
    explicit = str(tmp_path / "mine.npz")
    assert common.EngineArgs(**kw, text_cache=explicit).text_cache_path(None, 4, 8) == explicit


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_world(root, world=2):
    """``python -m aiic_tpu_torch.cli.worker --device cpu --mesh-devices 2
    --serve`` as ``world`` processes with torchrun's environment, the
    TINY_TEST seeded init on each; -> (the processes, the port), once rank
    0 is ready."""
    import os
    import subprocess
    import sys
    import time

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port, master = _free_port(), _free_port()
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(master), "GLOO_SOCKET_IFNAME": "lo",
           "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
    cmd = [sys.executable, "-m", "aiic_tpu_torch.cli.worker", "--device", "cpu",
           "--mesh-devices", str(world), "--serve", "--port", str(port), "--model", "tiny",
           "--text-cache", "none", "--max-batch", "8"]
    procs = [subprocess.Popen(cmd, cwd=str(root), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(world)]
    deadline = time.monotonic() + 90
    while True:
        try:
            if _http(port, "GET", "/ready")[0] == 200:
                return procs, port
        except OSError:
            pass
        if time.monotonic() > deadline or any(p.poll() is not None for p in procs):
            for p in procs:
                p.kill()
            logs = [p.communicate()[0][-2000:] for p in procs]
            raise AssertionError(f"the world did not get ready: {logs}")
        time.sleep(0.2)


def _http(port, method, path, body=None):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _exit_codes(procs, timeout):
    """Every process's exit code, all within ``timeout`` (killed after)."""
    import subprocess
    import time

    deadline = time.monotonic() + timeout
    try:
        return [p.wait(timeout=max(0.1, deadline - time.monotonic())) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"a rank outlived {timeout} s: "
                             f"{[p.communicate()[0][-2000:] for p in procs]}")


def _jpeg():
    import io

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(5).integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(
        buf, format="JPEG")
    return buf.getvalue()


def test_mesh_devices_refused(tmp_path, monkeypatch):
    """``--mesh-devices 1`` serves through the mesh path
    (``create_mesh(1, tp=1)``: a world of one rank) and gives the JAX
    engine's results with its own ``--mesh-devices 1``; a world of two
    ranks, once refused, serves: ``--mesh-devices 2 --serve`` as two
    processes with torchrun's environment answers ``POST /analyze``, and
    SIGTERM to rank 0 ends both with exit code 0."""
    monkeypatch.chdir(tmp_path)
    weights = str(tmp_path / "w.npz")
    save_clip_weights(init_clip_params(jax.random.PRNGKey(0), JAX_TINY), weights)
    kw = dict(model="tiny", weights=weights, mesh_devices=1, text_cache="none")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # loaded weights with the hermetic vocabulary
        ours = common.EngineArgs(device="cpu", **kw).build_analyzer(log=lambda *_: None)
        ref = jax_common.EngineArgs(**kw).build_analyzer(log=lambda *_: None)
    assert tuple(ours.mesh.shape) == (1, 1) and ref.mesh is not None
    px = np.random.default_rng(4).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    got, want = ours.classify_pixels(px), ref.classify_pixels(px)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=TOL, rtol=0, err_msg=k)
    procs, port = _worker_world(tmp_path)
    try:
        status, ans = _http(port, "POST", "/analyze", _jpeg())
        assert status == 200 and set(ans) == {"is_interior", "interior_confidence",
                                              "detected_category", "analysis", "reason"}
        procs[0].send_signal(signal.SIGTERM)
        assert _exit_codes(procs, 60) == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()


def test_worker_world_stops_on_sigterm_to_every_rank(tmp_path):
    """SIGTERM to both ranks at once (as torchrun forwards it): rank 0's
    stop command ends the follower, each with exit code 0."""
    procs, port = _worker_world(tmp_path)
    try:
        assert _http(port, "POST", "/analyze", _jpeg())[0] == 200
        for p in procs:
            p.send_signal(signal.SIGTERM)
        assert _exit_codes(procs, 60) == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()


def test_worker_world_dead_follower_fails_rank0(tmp_path):
    """A follower killed outright: rank 0's next request fails with an
    error status instead of hanging, and rank 0 exits 1 within the lane's
    timeout."""
    from aiic_tpu_torch.parallel.lane import TIMEOUT_S

    procs, port = _worker_world(tmp_path)
    try:
        procs[1].kill()
        procs[1].wait(timeout=30)
        status, body = _http(port, "POST", "/analyze", _jpeg())
        assert status >= 500, body
        assert _exit_codes(procs[:1], TIMEOUT_S) == [1]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()


def test_serve_without_cuda_fails_instead_of_serving_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    served = []
    monkeypatch.setattr("aiic_tpu_torch.serve.app.build_serving_app",
                        lambda *a, **k: served.append(1))
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_worker.main(["--serve", "--model", "tiny", "--text-cache", "none"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_main.main(["--analyze-csv", "x.csv", "--model", "tiny", "--text-cache", "none"])
    assert not served


def test_main_without_csv_returns_1(capsys):
    assert cli_main.main(["--device", "cpu"]) == 1
    assert "--analyze-csv" in capsys.readouterr().out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One seeded JAX init saved as npz: both packages' --weights load it."""
    root = tmp_path_factory.mktemp("cli")
    path = str(root / "tiny.npz")
    save_clip_weights(init_clip_params(jax.random.PRNGKey(11), JAX_TINY), path)
    ds = root / "dataset.json"
    ds.write_text(json.dumps({"training_data": TRAINING}, ensure_ascii=False), encoding="utf-8")
    return path, str(ds)


def _photos(root, n=5):
    rng = np.random.default_rng(12)
    rows, paths = ["offer_id,seq,url"], []
    for i in range(n):
        p = root / f"p{i}.{'jpg' if i % 2 == 0 else 'png'}"
        Image.fromarray(rng.integers(0, 256, (40 + i, 48, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    paths.append(str(root / "missing.jpg"))
    rows += [f"o{i // 2},{i % 2},{p}" for i, p in enumerate(paths)]
    (root / "photos.csv").write_text("\n".join(rows) + "\n", encoding="utf-8")
    return str(root / "photos.csv")


def _same_record(g, w):
    assert set(g) == set(w)
    for k in set(g) - {"interior_confidence", "analysis"}:
        assert g[k] == w[k], k
    assert abs(g["interior_confidence"] - w["interior_confidence"]) <= TOL
    assert set(g["analysis"]) == set(w["analysis"])
    for cat, top in g["analysis"].items():
        assert [a for a, _ in top] == [a for a, _ in w["analysis"][cat]]
        np.testing.assert_allclose([v for _, v in top], [v for _, v in w["analysis"][cat]],
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("extra", [[], ["--no-filter-interiors", "--batch-size", "2"]],
                         ids=["filter", "nofilter"])
def test_analyze_csv_end_to_end_matches_jax(weights, tmp_path, monkeypatch, extra):
    wpath, ds = weights
    monkeypatch.chdir(tmp_path)
    csv = _photos(tmp_path)
    argv = ["--analyze-csv", csv, "--model", "tiny", "--weights", wpath, "--dataset-json", ds,
            "--text-cache", "none"] + extra
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # loaded weights with the hermetic vocabulary
        assert cli_main.main(argv + ["--device", "cpu", "--output", "ours.json"]) == 0
        jargs = jax_main.build_parser().parse_args(argv)
        # the JAX engine in one stream batch: its stream can lose its end
        # behind two or more (the port's runs --batch-size 2: three)
        jax_main.analyze_images_from_csv(
            csv, max_images=jargs.max_images, batch_size=16,
            filter_interiors=not jargs.no_filter_interiors,
            confidence_threshold=jargs.confidence_threshold, out_path="ref.json",
            engine=jax_common.EngineArgs.from_args(jargs), log=lambda *_: None)
    ours = json.loads(open("ours.json", encoding="utf-8").read())
    ref = json.loads(open("ref.json", encoding="utf-8").read())
    assert list(ours) == list(ref) and len(ours) == 6
    for k in ours:
        _same_record(ours[k], ref[k])
    assert ours["o2_1"]["detected_category"] == "load error"


def _drain_db(mod, paths):
    d = mod.InMemoryDB()
    d.insert_apartment("a1", title="t1")
    d.insert_apartment("a2", title="t2")
    for i, p in enumerate(paths):
        d.insert_image(f"i{i}", "a1" if i < 3 else "a2", p)
    return d


def test_worker_drain_end_to_end_matches_jax(weights, tmp_path, monkeypatch, capsys):
    """``python -m aiic_tpu_torch.cli.worker --max-apartments 2 --device cpu``
    on a DB of local images against the JAX worker on the same documents and
    weights file: the same DB state and export; ``--export-only`` exports
    without building an engine."""
    wpath, ds = weights
    monkeypatch.chdir(tmp_path)
    _photos(tmp_path)
    paths = [str(tmp_path / f"p{i}.{'jpg' if i % 2 == 0 else 'png'}") for i in range(5)]
    paths.insert(2, str(tmp_path / "missing.jpg"))
    ours, ref = _drain_db(db, paths), _drain_db(jax_db, paths)
    monkeypatch.setattr(db, "connect_db", lambda uri=None: ours)
    argv = ["--max-apartments", "2", "--model", "tiny", "--weights", wpath, "--dataset-json", ds,
            "--text-cache", "none", "--batch-size", "4"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert cli_worker.main(argv + ["--device", "cpu"]) == 0
        jargs = jax_cli_worker.build_parser().parse_args(argv)
        analyzer = jax_common.EngineArgs.from_args(jargs).build_analyzer(log=lambda *_: None)
        jax_worker.process_apartments_pipeline(
            max_apartments=2, batch_size=4, confidence_threshold=0.3, db=ref, analyzer=analyzer,
            export_file="ref_export.json", log=lambda *_: None)
    assert "exported -> analysis_export.json" in capsys.readouterr().out
    skip = ("analyzed_at", "analysis_date", "analysis_confidence", "confidence")
    for k in ours.images:
        a, b = ours.images[k], ref.images[k]
        assert {x: v for x, v in a.items() if x not in skip} == \
            {x: v for x, v in b.items() if x not in skip}, k
        assert abs(a.get("analysis_confidence", 0) - b.get("analysis_confidence", 0)) <= TOL
    assert ours.images["i2"]["attempts"] == 1 and ours.images["i2"]["analysis_status"] == "pending"
    exp = json.loads(open("analysis_export.json", encoding="utf-8").read())
    jexp = json.loads(open("ref_export.json", encoding="utf-8").read())
    assert [r["apartment_id"] for r in exp] == [r["apartment_id"] for r in jexp] == ["a1", "a2"]
    for x, y in zip(exp, jexp):
        assert x["room_distribution"] == y["room_distribution"]
        assert x["overall_style"]["style"] == y["overall_style"]["style"]
        assert abs(x["confidence"] - y["confidence"]) <= TOL
        assert (x["analyzed_images"], x["total_images"]) == (y["analyzed_images"],
                                                            y["total_images"])
    assert cli_worker.main(["--export-only"]) == 0
    assert "exported -> analysis_export.json" in capsys.readouterr().out


def test_build_analyzer_reaches_the_engine(weights, tmp_path, monkeypatch):
    wpath, ds = weights
    monkeypatch.chdir(tmp_path)
    args = cli_worker.build_parser().parse_args(
        ["--model", "tiny", "--dataset-json", ds, "--device", "cpu", "--quantize",
         "--wire-format", "patch"])
    eng = common.EngineArgs.from_args(args).build_analyzer(max_batch=4, log=lambda *_: None)
    assert (eng.dtype, eng.quantized, eng.wire_format, eng.max_batch, eng.device.type) == (
        torch.bfloat16, True, "patch", 4, "cpu")
    assert eng.category_names == ["styles", "characteristics", "materials", "colors",
                                  "room_types"]
    cache = common.EngineArgs.from_args(args).text_cache_path(None, 4, 8)
    assert (tmp_path / cache).exists()  # the auto cache was written at build
    again = common.EngineArgs.from_args(args).build_analyzer(max_batch=4, log=lambda *_: None)
    assert torch.equal(again.det_text, eng.det_text)


@pytest.mark.parametrize("cli", ["worker", "main", "train_lora"])
def test_platform_env_sets_each_cli_device_default(cli, monkeypatch):
    """``AIIC_PLATFORM=cpu`` (``utils.platform.apply_platform_env``) makes
    ``cpu`` each CLI's ``--device`` default, as the caller's choice; no value
    leaves ``cuda``; a value the port does not run on is refused."""
    import importlib

    build = importlib.import_module(f"aiic_tpu_torch.cli.{cli}").build_parser
    monkeypatch.setenv("AIIC_PLATFORM", "cpu")
    assert build().parse_args([]).device == "cpu"
    assert build().parse_args(["--device", "cuda"]).device == "cuda"
    monkeypatch.delenv("AIIC_PLATFORM")
    assert build().parse_args([]).device == "cuda"
    monkeypatch.setenv("AIIC_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="AIIC_PLATFORM"):
        build()


def test_kernel_build_cache_stays_ignored():
    """The nvcc build persists under ``aiic_tpu_torch/_build/`` (why XLA's
    compilation cache has no counterpart in ``utils.platform``); git ignores
    it."""
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, ".gitignore"), encoding="utf-8") as f:
        assert "aiic_tpu_torch/_build/" in f.read().split()
