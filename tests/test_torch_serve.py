"""The port's serving layers against the JAX package: the dynamic batcher,
the REST server and app, the queue DB, the apartment worker, the metrics,
the logging and profiling helpers.

The engines are fp32 at TINY_TEST on the CPU with the JAX engine's weights
carried into the port (``params_from_numpy``); ``attn_impl="auto"`` is the
plain composition on the CPU in both packages. Bars: features and
confidences within 1e-5; verdicts, categories, top-k names, status codes,
headers, JSON keys and DB documents equal (timestamps aside).

The batcher tests count batches without sleeping for a window: a batch is
held open by an event, or closes because it is full, so the counts do not
depend on the machine's speed (the JAX package's
``test_dynamic_batcher_pipelined_coalesces_while_device_busy`` sleeps and
counts, and fails in loaded runs). Every wait has a timeout.
"""

import base64
import io
import json
import logging
import os
import sys
import threading
import time
import urllib.error
import urllib.request
import warnings

import jax
import numpy as np
import pytest
import torch

from aiic_tpu.engine import InteriorAnalyzer as JaxAnalyzer
from aiic_tpu.models.config import TINY_TEST as JAX_TINY
from aiic_tpu.models.init import flatten_params, init_clip_params
from aiic_tpu.serve import app as jax_app
from aiic_tpu.serve import batcher as jax_batcher
from aiic_tpu.serve import db as jax_db
from aiic_tpu.serve import metrics as jax_metrics
from aiic_tpu.serve import rest as jax_rest
from aiic_tpu.serve import worker as jax_worker
from aiic_tpu.utils import logging as jax_logging
from aiic_tpu.utils import profiling as jax_profiling
from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer
from aiic_tpu_torch.models.config import TINY_TEST
from aiic_tpu_torch.models.init import params_from_numpy
from aiic_tpu_torch.serve import app, batcher, db, metrics, rest, worker
from aiic_tpu_torch.serve.batcher import BatcherOverloaded, DynamicBatcher
from aiic_tpu_torch.utils import logging as port_logging
from aiic_tpu_torch.utils import profiling

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
WAIT = 20.0  # seconds any single wait in these tests may take

TRAINING = [
    {"image_path": "a.jpg", "style": "nowoczesny", "characteristics": ["jasne"],
     "materials": ["drewno"], "colors": ["biały"], "room_type": "kuchnia"},
    {"image_path": "b.jpg", "style": "klasyczny", "characteristics": ["ciemne"],
     "materials": ["marmur"], "colors": ["czarny"], "room_type": "salon"},
]


@pytest.fixture(scope="module")
def engines():
    jp = init_clip_params(jax.random.PRNGKey(0), JAX_TINY)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # loaded weights with the hermetic vocabulary
        ref = JaxAnalyzer(jp, JAX_TINY, training_data=TRAINING, max_batch=8)
        ours = InteriorAnalyzer(params_from_numpy(flatten_params(jp)), TINY_TEST,
                                training_data=TRAINING, max_batch=8, device="cpu")
    return ref, ours


def _encoded(seed, w, h, fmt):
    """A flat colour, a gradient, a checkerboard or noise (by seed), so that
    the seeded tiny weights judge some interior and the answers carry their
    attribute top-5."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a, b = rng.integers(0, 256, 3), rng.integers(0, 256, 3)
    arr = [np.broadcast_to(a, (h, w, 3)), a * (1 - xx[..., None] / w) + b * (xx[..., None] / w),
           np.where(((xx * 4 // w + yy * 4 // h) % 2)[..., None] == 1, a, b),
           rng.integers(0, 256, (h, w, 3))][seed % 4]
    buf = io.BytesIO()
    Image.fromarray(np.asarray(arr, np.float64).clip(0, 255).astype(np.uint8)).save(buf, format=fmt)
    return buf.getvalue()


JPEG_MAGIC = bytes([0xFF, 0xD8])
IMAGES = [_encoded(1, 48, 40, "JPEG"), _encoded(2, 36, 60, "PNG"), _encoded(3, 64, 64, "JPEG"),
          _encoded(4, 40, 40, "PNG")]


def _files(root, blobs, tag="im"):
    paths = []
    for i, blob in enumerate(blobs):
        ext = "jpg" if blob.startswith(JPEG_MAGIC) else "png"
        p = root / f"{tag}{i}.{ext}"
        p.write_bytes(blob)
        paths.append(str(p))
    return paths


def _same_result(g, w):
    assert set(g) == set(w)
    for k in set(g) - {"interior_confidence", "analysis"}:
        assert g[k] == w[k], k
    if "interior_confidence" in g:
        assert abs(g["interior_confidence"] - w["interior_confidence"]) <= TOL
    if "analysis" in g:
        assert set(g["analysis"]) == set(w["analysis"])
        for cat, top in g["analysis"].items():
            assert [a for a, _ in top] == [a for a, _ in w["analysis"][cat]]
            np.testing.assert_allclose([v for _, v in top],
                                       [v for _, v in w["analysis"][cat]], atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# The batcher
# ---------------------------------------------------------------------------


def _sums(items):
    return [float(x.sum()) for x in items]


def _wait_until(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_batcher_coalesces_a_full_batch_and_fans_out(pipelined):
    """Eight queued requests with max_batch 8 and a long wait close as one
    full batch; each future gets its own row's result."""
    seen = []
    gate = threading.Event()

    def run_batch(items):
        gate.wait(WAIT)
        seen.append(items.shape[0])
        return items if pipelined else _sums(items)

    kw = dict(fetch_batch=_sums) if pipelined else {}
    b = DynamicBatcher(run_batch, max_batch=8, max_wait_ms=5000.0, metrics=metrics.Metrics(),
                       **kw)
    try:
        items = [np.full((2, 2), i, np.float32) for i in range(8)]
        futs = [b.submit(x) for x in items]
        gate.set()
        assert [f.result(timeout=WAIT) for f in futs] == _sums(items)
        assert seen == [8]
        assert b.metrics.snapshot()["batches_of_size_8_total"] == 1
    finally:
        b.close()


def test_batcher_dispatches_the_next_batch_while_one_is_fetched():
    """Pipelined, depth 2: batch 2 is dispatched while batch 1's fetch is
    still waiting; with both slots taken a third waits for a free one."""
    seen = []
    release = threading.Event()

    def fetch(items):
        release.wait(WAIT)
        return _sums(items)

    b = DynamicBatcher(lambda items: seen.append(float(items[0][0])) or items, max_batch=1,
                       max_wait_ms=1.0, fetch_batch=fetch, pipeline_depth=2,
                       metrics=metrics.Metrics())
    try:
        futs = [b.submit(np.full((1,), float(i), np.float32)) for i in range(2)]
        _wait_until(lambda: seen == [0.0, 1.0], "two dispatches before any fetch ends")
        assert not any(f.done() for f in futs)
        release.set()
        assert [f.result(timeout=WAIT) for f in futs] == [0.0, 1.0]
        _wait_until(lambda: b._inflight == 0, "the in-flight count to drain")
    finally:
        release.set()
        b.close()


@pytest.mark.parametrize("where", ["sync", "dispatch", "fetch"])
def test_batcher_errors_reach_every_future(where):
    def boom(_):
        raise RuntimeError("boom")

    if where == "sync":
        b = DynamicBatcher(boom, max_batch=4, max_wait_ms=1.0, metrics=metrics.Metrics())
    elif where == "dispatch":
        b = DynamicBatcher(boom, fetch_batch=_sums, max_batch=4, max_wait_ms=1.0,
                           metrics=metrics.Metrics())
    else:
        b = DynamicBatcher(lambda items: items, fetch_batch=boom, max_batch=4,
                           max_wait_ms=1.0, metrics=metrics.Metrics())
    try:
        futs = [b.submit(np.zeros((1,))) for _ in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="boom"):
                f.result(timeout=WAIT)
        _wait_until(lambda: b.metrics.snapshot().get("batch_errors_total", 0) >= 1,
                    "the error count")
        # the batcher still serves
        ok = DynamicBatcher(_sums, max_batch=4, max_wait_ms=1.0, metrics=metrics.Metrics())
        assert ok.submit(np.ones((2,))).result(timeout=WAIT) == 2.0
        ok.close()
    finally:
        b.close()


def test_batcher_pipelined_matches_sync():
    rng = np.random.default_rng(0)
    items = [rng.standard_normal((3, 3)).astype(np.float32) for _ in range(40)]
    sync = DynamicBatcher(_sums, max_batch=8, max_wait_ms=2.0, metrics=metrics.Metrics())
    piped = DynamicBatcher(lambda x: x, fetch_batch=_sums, max_batch=8, max_wait_ms=2.0,
                           pipeline_depth=2, metrics=metrics.Metrics())
    try:
        a = [f.result(timeout=WAIT) for f in [sync.submit(x) for x in items]]
        b = [f.result(timeout=WAIT) for f in [piped.submit(x) for x in items]]
        assert a == b == _sums(items)
    finally:
        sync.close()
        piped.close()


def test_batcher_admission_control_is_exact():
    """max_queue 2: with one batch held in run_batch, two requests queue and
    the third is refused at once, counted, and later requests are taken
    again once the queue drains."""
    release = threading.Event()
    started = threading.Event()

    def run_batch(items):
        started.set()
        release.wait(WAIT)
        return _sums(items)

    m = metrics.Metrics()
    b = DynamicBatcher(run_batch, max_batch=1, max_wait_ms=1.0, max_queue=2, metrics=m)
    try:
        first = b.submit(np.ones((1,)))
        assert started.wait(WAIT)
        queued = [b.submit(np.ones((1,))) for _ in range(2)]
        with pytest.raises(BatcherOverloaded, match="queue full"):
            b.submit(np.ones((1,)))
        assert m.snapshot()["requests_rejected_total"] == 1
        release.set()
        assert [f.result(timeout=WAIT) for f in [first, *queued]] == [1.0, 1.0, 1.0]
        assert b.submit(np.ones((1,))).result(timeout=WAIT) == 1.0
    finally:
        release.set()
        b.close()


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_batcher_deadline_fails_the_batch_and_moves_on(pipelined):
    """A hung batch fails its requests with TimeoutError, calls the dead-letter
    hook with its size, and the next batch is served."""
    hang = threading.Event()
    dead = []

    def slow(items):
        if items[0][0] == 7:
            hang.wait(WAIT)
        return _sums(items) if not pipelined else items

    kw = dict(fetch_batch=_sums) if pipelined else {}
    b = DynamicBatcher(slow, max_batch=2, max_wait_ms=1.0, batch_timeout_s=0.2,
                       on_timeout=dead.append, metrics=metrics.Metrics(), **kw)
    try:
        fut = b.submit(np.full((1,), 7.0))
        with pytest.raises(TimeoutError):
            fut.result(timeout=WAIT)
        assert dead == [1]
        assert b.submit(np.full((1,), 3.0)).result(timeout=WAIT) == 3.0
        assert b.metrics.snapshot()["batch_timeouts_total"] == 1
    finally:
        hang.set()
        b.close()


def test_batcher_skips_cancelled_futures():
    gate = threading.Event()
    started = threading.Event()
    ran = []

    def run_batch(items):
        started.set()
        gate.wait(WAIT)
        ran.append(_sums(items))
        return _sums(items)

    b = DynamicBatcher(run_batch, max_batch=8, max_wait_ms=1.0, metrics=metrics.Metrics())
    try:
        first = b.submit(np.zeros((1,)))
        assert started.wait(WAIT)
        futs = [b.submit(np.full((1,), float(i))) for i in range(1, 5)]
        assert futs[0].cancel() and futs[2].cancel()
        gate.set()
        assert first.result(timeout=WAIT) == 0.0
        assert futs[1].result(timeout=WAIT) == 2.0 and futs[3].result(timeout=WAIT) == 4.0
        assert ran == [[0.0], [2.0, 4.0]]
    finally:
        gate.set()
        b.close()


def test_batcher_inflight_count_never_negative_under_stress():
    """Sixteen client threads against a pipelined batcher with a short
    interpreter switch interval: the in-flight count stays within
    [0, depth + 2] throughout (one batch in the completer's fetch, depth
    queued, one waiting to be queued) and returns to 0; every result routes
    to its own future."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    rng = np.random.default_rng(1)
    delays = rng.uniform(0, 0.002, 4096)
    b = DynamicBatcher(lambda x: x, fetch_batch=lambda x: (time.sleep(delays[len(x)]),
                                                           _sums(x))[1],
                       max_batch=4, max_wait_ms=0.5, pipeline_depth=2,
                       metrics=metrics.Metrics())
    seen, errors, stop = [], [], threading.Event()

    def watch():
        while not stop.is_set():
            seen.append(b._inflight)

    def client(k):
        try:
            for i in range(40):
                v = float(k * 1000 + i)
                if b.submit(np.full((1,), v)).result(timeout=WAIT) != v:
                    errors.append((k, i))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    clients = [threading.Thread(target=client, args=(k,), daemon=True) for k in range(16)]
    try:
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in clients)
        _wait_until(lambda: b._inflight == 0, "the in-flight count to drain")
    finally:
        stop.set()
        watcher.join(timeout=WAIT)
        sys.setswitchinterval(old)
        b.close()
    assert not errors
    assert seen and min(seen) >= 0 and max(seen) <= b.pipeline_depth + 2


# ---------------------------------------------------------------------------
# Metrics, logging, profiling, the DB
# ---------------------------------------------------------------------------


def test_metrics_match_jax():
    ours, ref = metrics.Metrics(), jax_metrics.Metrics()
    for m in (ours, ref):
        m.inc("requests_total")
        m.inc("requests_total", 2)
        m.gauge("queue_depth", 3)
        m.observe_batch(4, 8, 0.5)
        m.observe_batch(8, 8, 0.5)
        for s in (0.001, 0.002, 0.004, 0.1):
            m.observe_latency("analyze", s)
        with m.stages.stage("dispatch"):
            pass
    a, b = ours.snapshot(), ref.snapshot()
    assert set(a) - {"batches_of_size_4_total", "batches_of_size_8_total"} == set(b)
    assert a["batches_of_size_4_total"] == a["batches_of_size_8_total"] == 1
    for k in b:
        if k in ("uptime_seconds",) or k.startswith("stage_"):
            continue
        assert a[k] == b[k], k
    hist, jhist = profiling.LatencyHistogram(), jax_profiling.LatencyHistogram()
    for s in np.random.default_rng(2).lognormal(-5, 1.5, 500):
        hist.record(s)
        jhist.record(s)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert hist.quantile(q) == jhist.quantile(q)


def test_json_log_format_and_logger_match_jax(monkeypatch):
    rec = logging.LogRecord("aiic", logging.INFO, __file__, 1, "served %d", (3,), None)
    rec.fields = {"images": 3, "ms": 1.5}
    assert json.loads(port_logging._JsonFormatter().format(rec)) == \
        json.loads(jax_logging._JsonFormatter().format(rec))
    monkeypatch.setenv("AIIC_LOG_JSON", "1")
    logger = port_logging.get_logger("aiic_torch_test_logger")
    assert isinstance(logger.handlers[0].formatter, port_logging._JsonFormatter)
    assert port_logging.get_logger("aiic_torch_test_logger") is logger and len(logger.handlers) == 1


def test_device_trace_writes_a_profiler_trace(tmp_path):
    with profiling.device_trace(None):
        pass
    with profiling.device_trace(str(tmp_path)):
        torch.ones(8) @ torch.ones(8)
    assert list(tmp_path.glob("*.json")), list(tmp_path.iterdir())


def _seed_db(mod, paths):
    d = mod.InMemoryDB()
    d.insert_apartment("apt1", title="Mieszkanie 3-pokojowe")
    d.insert_apartment("apt2", title="Kawalerka")
    for i, p in enumerate(paths[:3]):
        d.insert_image(f"img{i}", "apt1", p)
    d.insert_image("img_bad", "apt1", paths[-1] + ".missing.jpg")
    for i, p in enumerate(paths[3:]):
        d.insert_image(f"img{3 + i}", "apt2", p)
    return d


def _plain(doc):
    """A stored document without its wall-clock timestamps."""
    return {k: v for k, v in doc.items() if k not in ("analyzed_at", "analysis_date",
                                                       "dead_lettered_at")}


def test_in_memory_db_contract_matches_jax(tmp_path):
    paths = [f"/img/{i}.jpg" for i in range(5)]
    ours, ref = _seed_db(db, paths), _seed_db(jax_db, paths)
    for d in (ours, ref):
        d.update_image_analysis("img0", "kuchnia", "boho", 0.75)
        d.update_image_analysis("img1", "not_interior", "unknown", 0.0)
        for _ in range(3):
            d.mark_image_attempt("img_bad", "load failed")
        d.record_dead_letter(None, "analyze request timed out (2 image(s))", source="rest",
                             count=2)
        d.save_apartment_analysis("apt1", {
            "overall_style": {"style": "boho", "confidence": 0.75},
            "room_distribution": {"kuchnia": 1}, "interior_images": 1, "total_images": 4})
    assert ours.get_pending_apartments() == ref.get_pending_apartments()
    assert ours.get_apartment_with_images("apt1") == ref.get_apartment_with_images("apt1")
    assert ours.get_apartment_with_images("nope") is ref.get_apartment_with_images("nope") is None
    for statuses in (None, ["completed"], ["failed", "not_interior"]):
        assert [_plain(x) for x in ours.get_images_for_apartment("apt1", statuses)] == \
            [_plain(x) for x in ref.get_images_for_apartment("apt1", statuses)]
    assert [_plain(x) for x in ours.list_dead_letters()] == \
        [_plain(x) for x in ref.list_dead_letters()]
    assert [_plain(x) for x in ours.list_results()] == [_plain(x) for x in ref.list_results()]
    assert ours.list_apartments() == ref.list_apartments()
    a = ours.export_analysis_results(str(tmp_path / "a.json"))
    b = ref.export_analysis_results(str(tmp_path / "b.json"))
    assert [_plain(x) for x in json.loads(open(a, encoding="utf-8").read())] == \
        [_plain(x) for x in json.loads(open(b, encoding="utf-8").read())]
    demo, jdemo = db.InMemoryDB(), jax_db.InMemoryDB()
    db.seed_demo_data(demo)
    jax_db.seed_demo_data(jdemo)
    assert demo.images == jdemo.images and demo.apartments == jdemo.apartments


def test_connect_db_without_pymongo_is_in_memory(monkeypatch):
    monkeypatch.setitem(sys.modules, "pymongo", None)  # import fails, nothing connects
    assert isinstance(db.connect_db("mongodb://127.0.0.1:9"), db.InMemoryDB)
    monkeypatch.delenv("MONGO_URI", raising=False)
    assert isinstance(db.connect_db(), db.InMemoryDB)


# ---------------------------------------------------------------------------
# The apartment worker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drains", [1, 3], ids=["one_drain", "three_drains"])
def test_worker_drain_matches_jax(engines, tmp_path, monkeypatch, drains):
    """The DB after ``process_apartments_pipeline`` and its export, against
    the JAX worker on the same documents and weights; three drains
    dead-letter the unreadable image in both."""
    ref, ours = engines
    monkeypatch.chdir(tmp_path)
    paths = _files(tmp_path, IMAGES + [_encoded(5, 50, 30, "JPEG")])
    dbs = {"ours": _seed_db(db, paths), "ref": _seed_db(jax_db, paths)}
    out = {}
    for _ in range(drains):
        for name, mod, eng in (("ours", worker, ours), ("ref", jax_worker, ref)):
            out[name] = mod.process_apartments_pipeline(
                db=dbs[name], analyzer=eng, batch_size=4, export_file=f"{name}.json",
                log=lambda *_: None)
    a, b = dbs["ours"], dbs["ref"]
    assert out == {"ours": "ours.json", "ref": "ref.json"}
    assert set(a.images) == set(b.images)
    for k in a.images:
        x, y = _plain(a.images[k]), _plain(b.images[k])
        assert abs(x.pop("analysis_confidence", 0.0) - y.pop("analysis_confidence", 0.0)) <= TOL
        assert x == y, k
    bad = a.images["img_bad"]
    assert bad["attempts"] == drains and (bad["analysis_status"] == "failed") == (drains == 3)
    assert [_plain(d) for d in a.list_dead_letters()] == [_plain(d) for d in b.list_dead_letters()]
    ea = json.loads(open("ours.json", encoding="utf-8").read())
    eb = json.loads(open("ref.json", encoding="utf-8").read())
    assert len(ea) == len(eb)
    for x, y in zip(ea, eb):
        x, y = _plain(x), _plain(y)
        for rec in (x, y):
            rec["conf"] = rec.pop("confidence")
            rec["style_conf"] = rec["overall_style"].pop("confidence")
        assert abs(x.pop("conf") - y.pop("conf")) <= TOL
        assert abs(x.pop("style_conf") - y.pop("style_conf")) <= TOL
        assert x == y


def test_worker_styles_and_aggregates_match_jax(engines):
    ref, ours = engines
    w = worker.ApartmentWorker(db.InMemoryDB(), ours)
    jw = jax_worker.ApartmentWorker(jax_db.InMemoryDB(), ref)
    np.testing.assert_allclose(w.style_text.numpy(), np.asarray(jw.style_text), atol=TOL, rtol=0)
    feats = ours.classify_pixels(np.random.default_rng(3).integers(
        0, 256, (5, 32, 32, 3), dtype=np.uint8))["features"]
    got, want = w._styles_for(feats), jw._styles_for(feats)
    assert [g["style"] for g in got] == [x["style"] for x in want]
    np.testing.assert_allclose([g["confidence"] for g in got], [x["confidence"] for x in want],
                               atol=TOL, rtol=0)
    analyses = [
        {"room_type": "kuchnia", "style": "boho", "style_confidence": 0.9},
        {"room_type": "salon", "style": "boho", "style_confidence": 0.7},
        {"room_type": "salon", "style": "retro", "style_confidence": 0.99},
    ]
    for data in (analyses, []):
        assert w.calculate_dominant_style(data) == jw.calculate_dominant_style(data)
        assert w.calculate_room_distribution(data) == jw.calculate_room_distribution(data)


# ---------------------------------------------------------------------------
# REST
# ---------------------------------------------------------------------------


def _call(port, method, path, body=None, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, dict(r.headers), json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read().decode())


@pytest.fixture(scope="module")
def servers(engines, tmp_path_factory):
    """Both packages' serving apps, as ``cli.worker --serve`` builds them, on
    ephemeral ports, over DBs holding the same documents."""
    ref, ours = engines
    root = tmp_path_factory.mktemp("rest")
    paths = _files(root, IMAGES)
    out = {}
    for name, mod_app, mod_db, eng in (("ours", app, db, ours), ("ref", jax_app, jax_db, ref)):
        server, b, warmed = mod_app.build_serving_app(
            eng, db=_seed_db(mod_db, paths + [str(root / "x.jpg")]), port=0, max_batch=8,
            warm_async=False, max_batch_items=16, log=lambda *_: None)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        out[name] = (server.server_address[1], server, b, warmed)
    yield out, paths
    for port, server, b, _ in out.values():
        server.shutdown()
        b.close()


def _drop_times(obj):
    if isinstance(obj, dict):
        return {k: _drop_times(v) for k, v in obj.items()
                if k not in ("timestamp", "analyzed_at", "analysis_date", "dead_lettered_at")}
    if isinstance(obj, list):
        return [_drop_times(v) for v in obj]
    return obj


@pytest.mark.parametrize("route", ["/", "/health", "/ready", "/test", "/apartments",
                                   "/process-pending", "/process/apt1", "/process/nope",
                                   "/results", "/dead-letters", "/export", "/nope"])
def test_rest_get_routes_match_jax(servers, route, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # /export writes analysis_export.json here
    (ports, _) = servers
    got = _call(ports["ours"][0], "GET", route)
    want = _call(ports["ref"][0], "GET", route)
    assert got[0] == want[0]
    assert got[1]["Content-Type"] == want[1]["Content-Type"] == "application/json; charset=utf-8"
    assert _drop_times(got[2]) == _drop_times(want[2])


def test_rest_metrics_route_names_match_jax(servers):
    """The same requests create the same /metrics names in both servers
    (the port adds its batch-size histogram), the stage timings among them."""
    (ports, _) = servers
    before = {n: set(_call(ports[n][0], "GET", "/metrics")[2]) for n in ports}
    for n in ports:
        assert _call(ports[n][0], "POST", "/analyze", IMAGES[0])[0] == 200
    after = {n: _call(ports[n][0], "GET", "/metrics")[2] for n in ports}
    new = {k for k in set(after["ours"]) - before["ours"] if not k.startswith("batches_of_size")}
    assert new <= set(after["ref"])  # the JAX server may have had them from earlier requests
    for k in ("images_total", "batches_total", "analyze_p50_ms", "stage_dispatch_mean_ms",
              "stage_fetch_p95_ms", "stage_serve_decode_count", "uptime_seconds"):
        assert k in after["ours"] and k in after["ref"], k
    assert any(k.startswith("batches_of_size_") for k in after["ours"])


@pytest.mark.parametrize("blob", ["jpeg", "png", "jpeg2", "undecodable"])
def test_rest_analyze_matches_jax(servers, blob):
    (ports, _) = servers
    body = {"jpeg": IMAGES[0], "png": IMAGES[1], "jpeg2": IMAGES[2],
            "undecodable": b"definitely not an image"}[blob]
    got = _call(ports["ours"][0], "POST", "/analyze", body)
    want = _call(ports["ref"][0], "POST", "/analyze", body)
    assert got[0] == want[0] == 200
    _same_result(got[2], want[2])
    if blob == "undecodable":
        assert got[2] == {"error": "could not decode image"}
    else:
        assert set(got[2]) == {"is_interior", "interior_confidence", "detected_category",
                               "analysis", "reason"}


def test_rest_analyze_equals_the_engine(servers, engines):
    """A REST answer is the engine's own result for the decoded pixels."""
    from aiic_tpu_torch.data.native_loader import preprocess_any_batch

    (ports, _) = servers
    _, ours = engines
    px, ok = preprocess_any_batch([IMAGES[3]], TINY_TEST.image_size)
    want = ours._result(ours.classify_pixels(px), 0, True, 0.3)
    got = _call(ports["ours"][0], "POST", "/analyze", IMAGES[3])[2]
    _same_result(got, want)


def test_rest_concurrent_analyze_matches_sequential(servers):
    (ports, _) = servers
    port = ports["ours"][0]
    want = [_call(port, "POST", "/analyze", b)[2] for b in IMAGES]
    got = [None] * 16

    def one(i):
        got[i] = _call(port, "POST", "/analyze", IMAGES[i % 4])[2]

    threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for i, g in enumerate(got):
        _same_result(g, want[i % 4])


@pytest.mark.parametrize("payload", ["b64", "paths", "both", "empty"])
def test_rest_analyze_batch_matches_jax(servers, payload):
    (ports, paths) = servers
    b64 = [base64.b64encode(b).decode() for b in IMAGES] + ["!!not base64!!", ""]
    urls = paths + [paths[0] + ".missing.png"]
    body = {"b64": {"images_b64": b64}, "paths": {"urls": urls},
            "both": {"urls": urls[:2], "images_b64": b64[2:]}, "empty": {}}[payload]
    data = json.dumps(body).encode()
    got = _call(ports["ours"][0], "POST", "/analyze-batch", data)
    want = _call(ports["ref"][0], "POST", "/analyze-batch", data)
    assert got[0] == want[0] == 200
    assert len(got[2]["results"]) == len(want[2]["results"])
    for g, w in zip(got[2]["results"], want[2]["results"]):
        _same_result(g, w)
    if payload == "b64":
        assert got[2]["results"][-1]["detected_category"] == "load error"


@pytest.fixture
def stalled_url():
    """A URL on this host whose GET answers only when the test ends (or
    after a minute): a fetch that stalls past any request's deadline."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    release = threading.Event()

    class Stall(BaseHTTPRequestHandler):
        def do_GET(self):
            release.wait(60)
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Stall)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}/stall.jpg"
    release.set()
    server.shutdown()
    server.server_close()


def _stream_threads():
    return {t for t in threading.enumerate() if t.name == "aiic-stream"}


def test_batch_deadline_bounds_a_stalled_url(engines, tmp_path, stalled_url):
    """``make_analyze_batch`` with a URL that stalls in the second chunk
    (the first chunk's 64 images already submitted to a batcher that holds
    them): TimeoutError within request_timeout + 2 s, the stream's producer
    thread ended, the 64 submitted futures cancelled and dead-lettered. The
    JAX package's copy waits for the stalled chunk (not compared here)."""
    from concurrent.futures import Future

    _, ours = engines

    class Holding:  # a batcher whose batches never finish
        def __init__(self):
            self.futures = []

        def submit(self, item):
            self.futures.append(Future())
            return self.futures[-1]

    held, dead = Holding(), []
    timeout = 1.0
    analyze_batch = app.make_analyze_batch(ours, held, request_timeout=timeout,
                                           on_dead_letter=dead.append)
    urls = _files(tmp_path, IMAGES) * 16 + [stalled_url]
    before = _stream_threads()
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="batch request exceeded"):
        analyze_batch({"urls": urls})
    assert time.monotonic() - t0 < timeout + 2.0
    _wait_until(lambda: not (_stream_threads() - before), "the stream's thread to end")
    assert len(held.futures) == 64 and all(f.cancelled() for f in held.futures)
    assert dead == [64]


def test_stalled_fetch_does_not_hold_the_process_exit():
    """A process that gives up on a stream whose fetch stalls exits at
    once: the fetch pool's threads are daemons (the interpreter would join a
    ThreadPoolExecutor's workers, here for the fetch's 30 s timeout)."""
    import subprocess

    code = (
        "import threading, time\n"
        "from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer\n"
        "from aiic_tpu_torch.data.pipeline import ByteStreamLoader\n"
        "class Stall(BaseHTTPRequestHandler):\n"
        "    def do_GET(self):\n"
        "        time.sleep(60)\n"
        "server = ThreadingHTTPServer(('127.0.0.1', 0), Stall)\n"
        "server.daemon_threads = True\n"
        "threading.Thread(target=server.serve_forever, daemon=True).start()\n"
        "url = f'http://127.0.0.1:{server.server_address[1]}/x.jpg'\n"
        "it = iter(ByteStreamLoader([url], batch_size=1, size=32))\n"
        "try:\n"
        "    it.get(0.5)\n"
        "except TimeoutError:\n"
        "    it.close()\n"
        "    print('gave up')\n")
    t0 = time.monotonic()
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, cwd=REPO)
    assert run.returncode == 0 and run.stdout.strip() == "gave up", run.stderr[-2000:]
    assert time.monotonic() - t0 < 15.0


def test_rest_batch_with_a_stalled_url_answers_504(engines, stalled_url):
    """``POST /analyze-batch`` whose only URL stalls answers 504 within
    request_timeout + 2 s, and the next request is answered."""
    _, ours = engines
    timeout = 1.0
    server, b, _ = app.build_serving_app(ours, port=0, max_batch=8, request_timeout=timeout,
                                         warm_async=False, log=lambda *_: None)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        before = _stream_threads()
        t0 = time.monotonic()
        status, _, body = _call(port, "POST", "/analyze-batch", json.dumps(
            {"urls": [stalled_url], "images_b64": [base64.b64encode(IMAGES[0]).decode()]}
        ).encode())
        assert status == 504 and body["dead_lettered"] is True
        assert time.monotonic() - t0 < timeout + 2.0
        _wait_until(lambda: not (_stream_threads() - before), "the stream's thread to end")
        assert _call(port, "POST", "/analyze", IMAGES[0])[0] == 200
    finally:
        server.shutdown()
        b.close()


@pytest.mark.parametrize("case", ["bad_json", "not_object", "urls_not_list", "too_many",
                                  "no_length", "post_nope"])
def test_rest_post_errors_match_jax(servers, case):
    (ports, _) = servers
    path, body = {
        "bad_json": ("/analyze-batch", b"{nope"),
        "not_object": ("/analyze-batch", b"[1, 2]"),
        "urls_not_list": ("/analyze-batch", b'{"urls": "a.jpg"}'),
        "too_many": ("/analyze-batch",
                     json.dumps({"images_b64": ["x"] * 17}).encode()),
        "no_length": ("/analyze", b""),
        "post_nope": ("/nope", b"x"),
    }[case]
    got = _call(ports["ours"][0], "POST", path, body)
    want = _call(ports["ref"][0], "POST", path, body)
    assert got[0] == want[0] and got[0] in (400, 404)
    assert got[2] == want[2]


@pytest.mark.parametrize("error", ["overloaded", "timeout", "bad_input", "other", "none"])
def test_rest_error_statuses_and_headers_match_jax(error):
    """Each package's server around an analyze function that fails as the
    batcher and the app fail: 503 with Retry-After, 504 dead-lettered, 400,
    500, and 503 with no analyzer attached."""
    got = {}
    for name, mod_rest, mod_batcher in (("ours", rest, batcher), ("ref", jax_rest, jax_batcher)):
        exc = {"overloaded": mod_batcher.BatcherOverloaded("request queue full (2); retry later"),
               "timeout": TimeoutError("request exceeded 0.1s"),
               "bad_input": ValueError("bad input"), "other": RuntimeError("boom"),
               "none": None}[error]

        def fail(_data, exc=exc):
            raise exc

        server = mod_rest.make_server(analyze_fn=None if exc is None else fail, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            got[name] = _call(server.server_address[1], "POST", "/analyze", b"img")
        finally:
            server.shutdown()
    (code, headers, body), (jcode, jheaders, jbody) = got["ours"], got["ref"]
    assert code == jcode == {"overloaded": 503, "timeout": 504, "bad_input": 400,
                             "other": 500, "none": 503}[error]
    assert body == jbody
    assert headers.get("Retry-After") == jheaders.get("Retry-After")
    assert (headers.get("Retry-After") == "1") == (error == "overloaded")


def test_rest_ready_gates_on_warmup_like_jax():
    for mod_rest in (rest, jax_rest):
        warmed = threading.Event()
        server = mod_rest.make_server(port=0, ready_fn=warmed.is_set)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        port = server.server_address[1]
        try:
            assert _call(port, "GET", "/ready")[0] == 503
            assert _call(port, "GET", "/health")[0] == 200
            warmed.set()
            status, _, body = _call(port, "GET", "/ready")
            assert status == 200 and body["ready"] is True
        finally:
            server.shutdown()


def test_serving_app_warms_in_the_background_then_serves(engines, monkeypatch):
    """build_serving_app's background warmup: /ready answers 503 until the
    buckets have run, then 200; the warmup runs the buckets 1..max_batch."""
    _, ours = engines
    hold, buckets = threading.Event(), []

    def warmup(sizes):
        buckets.append(list(sizes))
        hold.wait(WAIT)

    monkeypatch.setattr(ours, "warmup", warmup)
    server, b, warmed = app.build_serving_app(ours, port=0, max_batch=8, warm_async=True,
                                              log=lambda *_: None)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        assert _call(server.server_address[1], "GET", "/ready")[0] == 503
        hold.set()
        assert warmed.wait(WAIT)
        assert _call(server.server_address[1], "GET", "/ready")[0] == 200
        assert buckets == [[1, 2, 4, 8]]
    finally:
        server.shutdown()
        b.close()


@pytest.mark.parametrize("depth", [0, 2], ids=["sync", "pipelined"])
def test_run_batch_pair_matches_jax(engines, depth):
    ref, ours = engines
    px = np.random.default_rng(9).integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    out = {}
    for name, mod_app, eng in (("ours", app, ours), ("ref", jax_app, ref)):
        run, fetch = mod_app.make_run_batch(eng, 0.3, 4, depth)
        out[name] = run(px) if fetch is None else fetch(run(px))
        assert (fetch is None) == (depth == 0)
    assert len(out["ours"]) == len(out["ref"]) == 5
    for g, w in zip(out["ours"], out["ref"]):
        _same_result(g, w)
