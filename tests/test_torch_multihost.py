"""The port's data-parallel input seam (``aiic_tpu_torch.parallel.multihost``)
on a real two-rank gloo world on the CPU: the twin of tests/test_multihost.py.

Each rank of the world (tests/torch_ranks.py, started once for the module)
loads only its rows of the global batch (``process_local_rows``) and feeds
them through ``host_local_batch`` to the mesh's train step; the loss equals
the single-rank loss over the same global batch, the port's and JAX's. The
same world runs ``train_lora`` for an epoch over a (2, 1) mesh (the loss
curve of the single-rank run; rank 0 alone writes the adapters and the
state) and the int8 engine on 7 and 64 images. Bars: JAX's 1e-5; the
engine's serving bars of tests/test_torch_engine.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import torch_ranks as tr
from aiic_tpu.models import config as jax_config
from aiic_tpu_torch.models.config import TINY_TEST as CFG
from aiic_tpu_torch.models.init import flatten_params as torch_flatten
from aiic_tpu_torch.train import trainer

torch.set_num_threads(2)

TRAIN = dict(epochs=1, batch_size=8, rank=2, alpha=4, attach=["c_fc", "c_proj", "out_proj"],
             attn_impl="xla", image_attn_impl="xla")
TOL = 1e-5
# six of the dataset's images and a file that is missing everywhere; rank 1
# alone cannot read PATHS[BROKEN]
PATHS = [f"img{i}.png" for i in range(6)] + ["missing.png"]
BROKEN = 2


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    return tree


def _dataset(root):
    """tests/test_train.py's synthetic dataset: 24 random 40x40 PNGs."""
    from PIL import Image

    rng = np.random.default_rng(0)
    items = []
    for i in range(24):
        name = f"img{i}.png"
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)).save(root / name)
        items.append({"image_path": name, "style": ["nowoczesny", "klasyczny", "boho"][i % 3],
                      "characteristics": ["przestronne", "jasne"][: (i % 3)],
                      "materials": ["drewno"], "colors": ["biały"],
                      "room_type": ["kuchnia", "salon", ""][i % 3]})
    (root / "dataset.json").write_text(json.dumps({"training_data": items}), encoding="utf-8")


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return tr.once_per_run(tmp_path_factory, "world2", _world2)


def _world2(d):
    """The 2-rank world's outputs and the references, computed meanwhile."""
    params = tr.seeded_params("TINY_TEST", 0)
    flat = torch_flatten(params)
    np.savez(d / "params.npz", **flat)
    rng = np.random.default_rng(0)
    w, m, layers = CFG.text.width, CFG.text.mlp_dim, CFG.text.layers
    lora = {p: {"A": (rng.standard_normal((layers, a, 2)) * 0.02).astype(np.float32),
                "B": (rng.standard_normal((layers, 2, b)) * 0.02).astype(np.float32)}
            for p, (a, b) in {"out_proj": (w, w), "c_fc": (w, m), "c_proj": (m, w)}.items()}
    tr.save_tree(d / "lora.npz", lora)
    s = CFG.image_size
    px = rng.standard_normal((8, s, s, 3)).astype(np.float32)
    tokens = rng.integers(1, CFG.vocab_size - 2, (8, CFG.context_length)).astype(np.int32)
    tokens[:, 0] = CFG.vocab_size - 2
    tokens[:, -1] = CFG.vocab_size - 1
    np.savez(d / "train.npz", x=px, tokens=tokens)
    u8 = {n: rng.integers(0, 255, (n, s, s, 3), dtype=np.uint8) for n in (7, 64)}
    for n, a in u8.items():
        np.save(d / f"u8_{n}.npy", a)
    _dataset(d)
    cases = [dict(name="seam", case="seam", tp=1, inputs="train.npz", cfg=TRAIN),
             dict(name="train_lora", case="train_lora", tp=1, json="dataset.json",
                  save="out/adapters.pth", cfg=dict(TRAIN, epochs=2, seed=0))]
    cases += [dict(name=f"analyzer_{n}", case="analyzer", tp=1, wire="hwc",
                   pixels=f"u8_{n}.npy") for n in (7, 64)]
    cases.append(dict(name="analyzer_paths", case="analyzer_paths", tp=1, paths=PATHS,
                      broken=BROKEN, max_batch=4, cache="text_cache.npz"))
    procs = tr.start(d, 2, cases)
    try:
        ref = {}
        tc = trainer.TrainConfig(**TRAIN)
        opt = trainer.make_optimizer(tc, 1)
        ts, es = trainer.make_train_step(CFG, tc, opt, device="cpu")
        lt = {p: {ab: torch.from_numpy(v) for ab, v in dd.items()} for p, dd in lora.items()}
        x, t = torch.from_numpy(px), torch.from_numpy(tokens)
        ref["loss"] = float(ts(params, lt, opt.init(lt), x, t)[0])
        ref["eval"] = float(es(params, lt, x, t))
        from aiic_tpu.train import trainer as jt

        jcfg = jt.TrainConfig(**dict(TRAIN, attach=tuple(TRAIN["attach"])))
        jopt = jt.make_optimizer(jcfg, 1)
        jlora = jax.tree.map(jnp.asarray, lora)
        jstep, _ = jt.make_train_step(jax_config.TINY_TEST, jcfg, jopt)
        ref["jax_loss"] = float(jax.jit(jstep)(
            jax.tree.map(jnp.asarray, _unflatten(flat)), jlora, jopt.init(jlora),
            jnp.asarray(px), jnp.asarray(tokens), jax.random.PRNGKey(0))[0])
        ref["train_lora"] = trainer.train_lora(
            str(d / "dataset.json"), str(d / "single" / "adapters.pth"), params=params,
            config=CFG, cfg=trainer.TrainConfig(**dict(TRAIN, epochs=2, seed=0)), device="cpu",
            log=lambda *_: None)
        from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer

        eng = InteriorAnalyzer(params, CFG, training_data=tr.TRAINING, dtype=torch.bfloat16,
                               quantize=True, max_batch=8, device="cpu")
        for n, a in u8.items():
            ref[f"analyzer_{n}"] = eng.classify_pixels(a)
        paths = [str(d / p) for p in PATHS]
        eng = InteriorAnalyzer(params, CFG, training_data=tr.TRAINING, dtype=torch.bfloat16,
                               quantize=True, max_batch=4, device="cpu")
        ref["analyzer_paths"] = json.loads(json.dumps(tr.serving_record(eng, paths,
                                                                        paths[BROKEN])))
        ref["det_text"] = eng.det_text.numpy()
    finally:
        tr.join(procs)
    return d, ref


def test_two_process_dp_matches_single_process(world2):
    """Each rank feeds its 4 rows of the global 8 through the seam; the
    train and eval losses equal the single-rank losses over the same 8 rows,
    the port's and JAX's."""
    d, ref = world2
    outs = [tr.load(d, "seam", r) for r in range(2)]
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["rows"], np.arange(8)[r * 4:(r + 1) * 4])
        assert tuple(out["global_shape"])[0] == 8 and int(out["local_rows"]) == 4
        assert int(out["global_batch"]) == 8
        np.testing.assert_allclose(float(out["loss"]), ref["loss"], rtol=TOL)
        np.testing.assert_allclose(float(out["loss"]), ref["jax_loss"], rtol=TOL)
        np.testing.assert_allclose(float(out["eval"]), ref["eval"], rtol=TOL)
        np.testing.assert_array_equal(out["replicated"],
                                      np.load(d / "train.npz")["tokens"])
    assert float(outs[0]["loss"]) == float(outs[1]["loss"])


def test_train_lora_over_two_ranks_matches_one_rank(world2):
    """Two epochs of ``train_lora`` over a (2, 1) mesh: every rank draws the
    same order and prompts and loads its half of each batch (the train and
    the eval split); the losses and the best adapters are the single-rank
    run's; rank 0 alone writes."""
    d, ref = world2
    want = ref["train_lora"]
    outs = [tr.load(d, "train_lora", r) for r in range(2)]
    for out in outs:
        np.testing.assert_allclose(out["train_loss"], [h["train_loss"] for h in want["history"]],
                                   rtol=TOL)
        np.testing.assert_allclose(out["val_loss"], [h["val_loss"] for h in want["history"]],
                                   rtol=TOL)
        for p, dd in want["lora_tree"].items():
            for ab, v in dd.items():
                np.testing.assert_allclose(out[f"lora/{p}/{ab}"], v.numpy(), atol=2e-4, rtol=0)
    assert int(outs[0]["writes"]) > 0 and int(outs[1]["writes"]) == 0
    assert (d / "out" / "adapters.pth").exists() and (d / "out" / "adapters.pth.npz").exists()
    sd = torch.load(str(d / "out" / "adapters.pth"), map_location="cpu", weights_only=True)
    assert len(sd) == 6 * CFG.text.layers


@pytest.mark.parametrize("n", [7, 64])
def test_analyzer_over_two_ranks_matches_single_device(world2, n):
    """The int8 engine over two ranks (``max_batch`` 8): 7 images pad to the
    bucket 8, 64 run as eight full buckets; each rank classifies half of
    every bucket and the fetch gathers the rest."""
    d, ref = world2
    for r in range(2):
        out = tr.load(d, f"analyzer_{n}", r)
        assert int(out["bucket"]) == 8
        want = ref[f"analyzer_{n}"]
        np.testing.assert_array_equal(out[f"n{n}/top_idx"], want["top_idx"])
        for k in ("top_conf", "interior_mass", "non_interior_mass", "topk_vals", "features"):
            np.testing.assert_allclose(out[f"n{n}/{k}"], want[k], atol=TOL, rtol=0, err_msg=k)


def _same_result(got, want):
    """One path's result dict at tests/test_torch_engine.py's serving bars."""
    assert {k: v for k, v in got.items() if k not in ("interior_confidence", "analysis")} == \
        {k: v for k, v in want.items() if k not in ("interior_confidence", "analysis")}
    np.testing.assert_allclose(got["interior_confidence"], want["interior_confidence"],
                               atol=1e-3)
    assert list(got["analysis"]) == list(want["analysis"])
    for cat, attrs in want["analysis"].items():
        assert [a for a, _ in got["analysis"][cat]] == [a for a, _ in attrs]
        np.testing.assert_allclose([p for _, p in got["analysis"][cat]],
                                   [p for _, p in attrs], atol=1e-3)


def test_analyzer_paths_over_two_ranks_load_once(world2):
    """The engine's file and URL entry points over two ranks, where rank 1
    alone cannot read one image: rank 0 fetches and decodes for both, so
    every rank returns the single-device engine's result for every path
    (the missing file a load error on both) and no collective waits. The
    text features are rank 0's on both ranks, written once to the cache."""
    d, ref = world2
    want = ref["analyzer_paths"]
    with np.load(d / "text_cache.npz") as blob:
        cached = blob["det_text"]
    np.testing.assert_array_equal(cached, ref["det_text"])
    for r in range(2):
        out = tr.load(d, "analyzer_paths", r)
        np.testing.assert_array_equal(out["det_text"], cached)
        got = json.loads(str(out["record"]))
        assert sorted(got["batch"]) == sorted(want["batch"]) == sorted(str(d / p) for p in PATHS)
        assert got["batch"][str(d / "missing.png")]["detected_category"] == "load error"
        for p in want["batch"]:
            _same_result(got["batch"][p], want["batch"][p])
        assert [p for p, _ in got["interior"]] == [p for p, _ in want["interior"]]
        np.testing.assert_allclose([c for _, c in got["interior"]],
                                   [c for _, c in want["interior"]], atol=1e-3)
        assert [x["path"] for x in got["non_interior"]] == \
            [x["path"] for x in want["non_interior"]]
        _same_result(got["url"], want["url"])


# ---------------------------------------------------------------------------
# The worker over two ranks: rank 0 serves and drains, rank 1 follows
# ---------------------------------------------------------------------------

SERVE_TOL = 1e-5  # tests/test_torch_serve.py's REST bars (fp32 on the CPU)
HOLD_S, TIMEOUT_S = 3.0, 1.0  # the warmup's hold of the lane, the request's deadline


def _blobs(root):
    """Four encoded images (two JPEGs, two PNGs) as files, and the names of
    three of them again as the batch request's URLs (local paths)."""
    from PIL import Image

    rng = np.random.default_rng(21)
    names = []
    for i, (w, h, fmt) in enumerate([(48, 40, "JPEG"), (36, 60, "PNG"), (64, 64, "JPEG"),
                                     (40, 40, "PNG")]):
        yy, xx = np.mgrid[0:h, 0:w]
        a, b = rng.integers(0, 256, 3), rng.integers(0, 256, 3)
        arr = [np.broadcast_to(a, (h, w, 3)), a * (1 - xx[..., None] / w) + b * (xx[..., None] / w),
               np.where(((xx * 4 // w + yy * 4 // h) % 2)[..., None] == 1, a, b),
               rng.integers(0, 256, (h, w, 3))][i]
        name = f"blob{i}.{'jpg' if fmt == 'JPEG' else 'png'}"
        Image.fromarray(np.asarray(arr, np.float64).clip(0, 255).astype(np.uint8)).save(
            root / name, format=fmt)
        names.append(name)
    return names


def _serve_refs(d, flat, blob_names, url_names, drain_names):
    """The same requests against the port's single-device serving app and
    the JAX package's over a 2-device JAX mesh (``mesh_devices=2``), and
    the JAX drain on the same documents."""
    import threading

    from aiic_tpu.cli import worker as jax_cli_worker
    from aiic_tpu.engine import InteriorAnalyzer as JaxAnalyzer
    from aiic_tpu.parallel import create_mesh as jax_mesh
    from aiic_tpu.serve import app as jax_app
    from aiic_tpu.serve import db as jax_db
    from aiic_tpu.serve import worker as jax_worker
    from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer
    from aiic_tpu_torch.models.init import params_from_numpy
    from aiic_tpu_torch.serve import app

    blobs = [(d / n).read_bytes() for n in blob_names]
    urls = [str(d / n) for n in url_names]
    jeng = JaxAnalyzer(jax.tree.map(jnp.asarray, _unflatten(flat)), jax_config.TINY_TEST,
                       training_data=tr.TRAINING, max_batch=8, mesh=jax_mesh(2, tp=1))
    ours = InteriorAnalyzer(params_from_numpy(flat), CFG, training_data=tr.TRAINING,
                            max_batch=8, device="cpu")
    refs = {}
    for name, mod, eng in (("jax", jax_app, jeng), ("single", app, ours)):
        for depth in (0, 2):
            server, batcher, _ = mod.build_serving_app(
                eng, port=0, max_batch=8, pipeline_depth=depth, warm_async=False,
                max_batch_items=16, log=lambda *_: None)
            threading.Thread(target=server.serve_forever, daemon=True).start()
            try:
                refs[f"{name}{depth}"] = tr._serve_requests(server.server_address[1], blobs, urls)
            finally:
                server.shutdown()
                batcher.close()
    db = jax_db.InMemoryDB()
    db.insert_apartment("a1", title="t1")
    db.insert_apartment("a2", title="t2")
    for i, p in enumerate(drain_names):
        db.insert_image(f"i{i}", "a1" if i < 3 else "a2", str(d / p))
    args = jax_cli_worker.build_parser().parse_args(["--batch-size", "4"])
    jax_worker.process_apartments_pipeline(
        max_apartments=args.max_apartments, batch_size=args.batch_size,
        confidence_threshold=args.confidence, db=db, analyzer=jeng,
        export_file=str(d / "jax_export.json"), log=lambda *_: None)
    refs["drain"] = {"images": json.loads(json.dumps(db.images, default=str)),
                     "export": json.loads((d / "jax_export.json").read_text())}
    return refs


@pytest.fixture(scope="module")
def serve_world2(tmp_path_factory):
    return tr.once_per_run(tmp_path_factory, "serve_world2", _serve_world2)


def _serve_world2(d):
    params = tr.seeded_params("TINY_TEST", 3)
    flat = torch_flatten(params)
    np.savez(d / "params.npz", **flat)
    names = _blobs(d)
    urls = names[:3] + ["missing.png"]
    drain = names[:2] + ["missing.jpg"] + names[2:]
    procs = tr.start(d, 2, [dict(name="serve", case="serve", tp=1, blobs=names, urls=urls,
                                 drain=drain, hold_s=HOLD_S, timeout_s=TIMEOUT_S)])
    try:
        refs = _serve_refs(d, flat, names, urls, drain)
    finally:
        tr.join(procs)
    return d, refs


def _same_answer(got, want):
    """Two REST answers (status, body) at tests/test_torch_serve.py's bars."""
    assert got[0] == want[0] == 200
    g, w = got[1], want[1]
    if "results" in w:
        assert len(g["results"]) == len(w["results"])
        for a, b in zip(g["results"], w["results"]):
            _same_answer((200, a), (200, b))
        return
    assert set(g) == set(w)
    for k in set(g) - {"interior_confidence", "analysis"}:
        assert g[k] == w[k], k
    if "interior_confidence" in w:
        assert abs(g["interior_confidence"] - w["interior_confidence"]) <= SERVE_TOL
    for cat, top in w.get("analysis", {}).items():
        assert [a for a, _ in g["analysis"][cat]] == [a for a, _ in top]
        np.testing.assert_allclose([v for _, v in g["analysis"][cat]], [v for _, v in top],
                                   atol=SERVE_TOL, rtol=0)


@pytest.mark.parametrize("depth", [0, 2], ids=["sync", "pipelined"])
@pytest.mark.parametrize("kind", ["sequential", "concurrent", "batch"])
def test_worker_over_two_ranks_serves_as_jax_and_one_device(serve_world2, depth, kind):
    """Rank 0's serving app on the engine lane, rank 1 following: the
    answers to each blob alone, 16 at once and one /analyze-batch (URLs, a
    missing one among them, and base64) equal the port's single-device app
    and the JAX app over a 2-device mesh."""
    d, refs = serve_world2
    out = tr.load(d, "serve", 0)
    got = json.loads(str(out["serving"]))[f"depth{depth}"][kind]
    for ref in (f"single{depth}", f"jax{depth}"):
        want = refs[ref][kind]
        if kind == "batch":
            _same_answer(got, want)
            assert got[1]["results"][3]["detected_category"] == "load error"
        else:
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _same_answer(g, w)
    assert int(tr.load(d, "serve", 1)["follow_rc"]) == 0


def test_worker_drain_over_two_ranks_matches_jax(serve_world2):
    """``cli.worker.run_rank`` drains over two ranks (rank 0 leads, reads
    and writes the DB, rank 1 follows): the DB documents and the export the
    JAX drain stores (tests/test_torch_serve.py's comparison)."""
    d, refs = serve_world2
    outs = [tr.load(d, "serve", r) for r in range(2)]
    assert [int(o["drain_rc"]) for o in outs] == [0, 0]
    got, want = json.loads(str(outs[0]["drain"])), refs["drain"]
    skip = ("analyzed_at", "analysis_date", "analysis_confidence", "created_at", "updated_at")
    assert set(got["images"]) == set(want["images"])
    for k, a in got["images"].items():
        b = want["images"][k]
        assert {x: v for x, v in a.items() if x not in skip} == \
            {x: v for x, v in b.items() if x not in skip}, k
        assert abs(a.get("analysis_confidence", 0) - b.get("analysis_confidence", 0)) <= SERVE_TOL
    assert got["images"]["i2"]["attempts"] == 1
    assert [r["apartment_id"] for r in got["export"]] == \
        [r["apartment_id"] for r in want["export"]] == ["a1", "a2"]
    for x, y in zip(got["export"], want["export"]):
        assert x["room_distribution"] == y["room_distribution"]
        assert x["overall_style"]["style"] == y["overall_style"]["style"]
        assert abs(x["confidence"] - y["confidence"]) <= SERVE_TOL


def test_batch_timeout_over_two_ranks_keeps_the_lane_in_order(serve_world2):
    """A request whose batch waits past its deadline behind the warmup,
    which holds the lane: 504 at the deadline, dead-lettered; its dispatch
    still runs in its turn after the warmup, and the next request is
    answered as one device answers it."""
    d, refs = serve_world2
    got = json.loads(str(tr.load(d, "serve", 0)["serving"]))["timeout"]
    first = got["first"]
    assert first["status"] == 504 and first["body"]["dead_lettered"] is True
    assert TIMEOUT_S - 0.1 <= first["seconds"] < HOLD_S
    _same_answer(got["next"], refs["single2"]["sequential"][0])


def test_single_process_seam_is_identity():
    """``host_local_batch`` in a world of one: the local rows are the global
    batch, placed ``[Shard(0), Replicate()]``; ``replicated`` holds the
    data whole."""
    from aiic_tpu_torch.parallel import create_mesh
    from aiic_tpu_torch.parallel.multihost import global_batch_size, host_local_batch, replicated

    mesh = create_mesh(1, device="cpu")
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    arr = host_local_batch(mesh, x)
    assert tuple(arr.shape) == (8, 3)
    assert arr.placements == (Shard(0), Replicate())
    np.testing.assert_array_equal(arr.to_local().numpy(), x)
    assert global_batch_size(mesh, 8) == 8
    r = replicated(mesh, x)
    assert tuple(r.shape) == (8, 3) and r.placements == (Replicate(), Replicate())
    np.testing.assert_array_equal(r.to_local().numpy(), x)


def test_process_local_rows_disjoint_shards(monkeypatch):
    """Each data rank gets a disjoint global_batch/dp shard, the union the
    global batch once, JAX's shard for the same index; one rank: identity."""
    import aiic_tpu.parallel.multihost as jax_mh
    import aiic_tpu_torch.parallel.multihost as mh

    rows = np.arange(32)
    monkeypatch.setattr(mh, "_process_count", lambda mesh=None: 4)
    monkeypatch.setattr(jax_mh.jax, "process_count", lambda: 4)
    seen = []
    for p in range(4):
        monkeypatch.setattr(mh, "_process_index", lambda mesh=None, p=p: p)
        monkeypatch.setattr(jax_mh.jax, "process_index", lambda p=p: p)
        shard = mh.process_local_rows(rows)
        assert len(shard) == 8
        np.testing.assert_array_equal(shard, jax_mh.process_local_rows(rows))
        seen.extend(shard.tolist())
    assert sorted(seen) == rows.tolist()

    monkeypatch.setattr(mh, "_process_count", lambda mesh=None: 5)
    monkeypatch.setattr(jax_mh.jax, "process_count", lambda: 5)
    with pytest.raises(ValueError) as ours:
        mh.process_local_rows(rows)
    with pytest.raises(ValueError) as ref:
        jax_mh.process_local_rows(rows)
    assert str(ours.value) == str(ref.value)

    monkeypatch.setattr(mh, "_process_count", lambda mesh=None: 1)
    np.testing.assert_array_equal(mh.process_local_rows(rows), rows)
