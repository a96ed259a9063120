"""Ranks of a gloo world on the CPU for the port's mesh tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_multihost.py``).

    python tests/torch_ranks.py <plan.json> <rank>

The parent writes a plan (the world's size and the cases to run, each with
its mesh shape and options) and the inputs, as ``.npz`` files, into one
directory, then starts every rank with :func:`start` and collects them with
:func:`join` (each rank within a time limit; a rank that fails or hangs
fails the test). Each rank joins a ``FileStore`` rendezvous in that
directory, runs one thread, builds its meshes with
``aiic_tpu_torch.parallel.create_mesh``, runs the cases in order and writes
each case's outputs to ``<case>_<rank>.npz``. A rank imports neither JAX nor
the ``aiic_tpu`` package: its weights come through the port's parameter
bridge from the parent's numpy files.
"""

from __future__ import annotations

import datetime
import fcntl
import functools
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINING = [
    {"image_path": "a.jpg", "style": "nowoczesny", "characteristics": ["jasne"],
     "materials": ["drewno"], "colors": ["bialy"], "room_type": "kuchnia"},
    {"image_path": "b.jpg", "style": "klasyczny", "characteristics": ["ciemne"],
     "materials": ["marmur"], "colors": ["czarny"], "room_type": "salon"},
]
JOIN_SECONDS = 120


# ---------------------------------------------------------------------------
# The parent's side
# ---------------------------------------------------------------------------


def save_tree(path, tree) -> None:
    """A nested dict of arrays as one flat ``a/b/c`` npz."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v)
    walk(tree, "")
    np.savez(str(path), **flat)


def start(directory, world: int, cases: list):
    """Write the plan and start ``world`` ranks; -> the processes."""
    plan = os.path.join(str(directory), "plan.json")
    with open(plan, "w") as f:
        json.dump({"world": world, "dir": str(directory), "cases": cases}, f)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo", "CUDA_VISIBLE_DEVICES": ""}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), plan, str(r)],
                             cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(world)]


def join(procs, timeout: float = JOIN_SECONDS) -> None:
    """Wait for every rank, all within ``timeout``; kill them all and fail
    on a hang or an error."""
    deadline = time.monotonic() + timeout
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"a rank did not finish within {timeout} s")
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, bad


def once_per_run(tmp_path_factory, name: str, compute):
    """``compute(directory)`` once per pytest run: pytest-xdist's workers
    share the first one's result (a pickle beside their temporary
    directories, made under a file lock) instead of each starting a world
    of its own."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return compute(tmp_path_factory.mktemp(name))
    root = tmp_path_factory.getbasetemp().parent
    done = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not done.exists():
                directory = root / name
                directory.mkdir(exist_ok=True)
                result = compute(directory)
                with open(root / f"{name}.tmp", "wb") as f:
                    pickle.dump(result, f)
                os.replace(root / f"{name}.tmp", done)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    with open(done, "rb") as f:
        return pickle.load(f)


def load(directory, case: str, rank: int) -> dict:
    with np.load(os.path.join(str(directory), f"{case}_{rank}.npz")) as blob:
        return {k: blob[k] for k in blob.files}


# ---------------------------------------------------------------------------
# The ranks' side
# ---------------------------------------------------------------------------


def _tree(path):
    from aiic_tpu_torch.models.init import params_from_numpy

    with np.load(path) as blob:
        return params_from_numpy({k: blob[k] for k in blob.files})


def _np(x):
    import torch

    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.is_floating_point() else x.cpu().numpy()
    return np.asarray(x)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def reduced_config(name: str):
    """A preset at its published widths with its towers cut to two blocks
    (one for the text tower, whose vocabulary is cut too: an image encode
    never reads it)."""
    import dataclasses

    from aiic_tpu_torch.models import config

    cfg = getattr(config, name)
    if name == "TINY_TEST":
        return cfg
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, layers=2),
                               text=dataclasses.replace(cfg.text, layers=1), vocab_size=64)


def seeded_params(name: str, seed: int):
    """The port's seeded init of ``reduced_config(name)`` on the CPU (the
    same tensors in every process)."""
    import torch

    from aiic_tpu_torch.models.init import init_clip_params

    return init_clip_params(reduced_config(name), torch.Generator().manual_seed(seed))


def case_encode(mesh, d, c):
    """The image tower tensor-parallel over "model", rows over "data"."""
    import torch

    from aiic_tpu_torch.models.clip import encode_image, normalize_features
    from aiic_tpu_torch.parallel import param_pspecs, shard_params
    from aiic_tpu_torch.parallel.mesh import all_gather
    from aiic_tpu_torch.parallel.sharding import TensorParallel, batch_rows, local_tree

    if "preset" in c:
        params = seeded_params(c["preset"], c["seed"])
    else:
        params = _tree(os.path.join(d, "params.npz"))
    pixels = torch.from_numpy(np.load(os.path.join(d, c["pixels"])))
    local = local_tree(shard_params(params, mesh), param_pspecs(params), mesh)
    rows = batch_rows(pixels, mesh.size(0), mesh.get_local_rank("data"))
    f = normalize_features(encode_image(local, rows, reduced_config(c.get("preset", "TINY_TEST")),
                                        attn_impl="xla", tp=TensorParallel(mesh)))
    return {"feats": all_gather(f, mesh.get_group("data"))}


def case_classify(mesh, d, c):
    """The classify program, tensor-parallel (``kernels=False``) or with
    every axis data and the kernels' plain versions (``kernels=True``)."""
    import torch

    from aiic_tpu_torch.engine.programs import classify_batch
    from aiic_tpu_torch.models.init import tree_map
    from aiic_tpu_torch.ops.quant import quantize_model
    from aiic_tpu_torch.parallel import make_sharded_classify_fn, shard_params

    if "preset" in c:
        params = seeded_params(c["preset"], c["seed"])
    else:
        params = _tree(os.path.join(d, "params.npz"))
    kernels = c["kernels"]
    if kernels:
        params = quantize_model(tree_map(lambda t: t.to(torch.bfloat16), params))
    fn = functools.partial(classify_batch, config=reduced_config(c.get("preset", "TINY_TEST")),
                           interior_count=11,
                           dtype=torch.bfloat16 if kernels else torch.float32,
                           attn_impl="pallas" if kernels else "xla", topk=5)
    ins = np.load(os.path.join(d, c["inputs"]))
    sharded = make_sharded_classify_fn(mesh, fn, params, kernels=kernels)
    out = sharded(params if kernels else shard_params(params, mesh),
                  *(torch.from_numpy(ins[k]) for k in ("pixels", "det", "cat", "mask")))
    return out


def case_analyzer(mesh, d, c):
    """``InteriorAnalyzer(mesh=...)`` on an odd batch (the bucket rounds up
    to the mesh's size) and ``device_resize``'s warning."""
    import warnings

    import torch

    from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer
    from aiic_tpu_torch.models.config import TINY_TEST

    params = _tree(os.path.join(d, "params.npz"))
    eng = InteriorAnalyzer(params, TINY_TEST, training_data=TRAINING, dtype=torch.bfloat16,
                           quantize=True, max_batch=8, wire_format=c["wire"], device="cpu",
                           mesh=mesh)
    px = np.load(os.path.join(d, c["pixels"]))
    out = {f"n{len(px)}/{k}": v for k, v in eng.classify_pixels(px).items()}
    out["bucket"] = np.asarray(eng._final_bucket(min(len(px), 8), 8))  # the last chunk's
    if c.get("jpeg"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = eng.analyze_images_batch([os.path.join(d, c["jpeg"])], device_resize=True)
        out["warned"] = np.asarray(any("device_resize" in str(w.message) for w in caught))
        out["analyzed"] = np.asarray(os.path.join(d, c["jpeg"]) in res)
    return out


def serving_record(eng, paths, broken: str) -> dict:
    """The engine's path and URL entry points on ``paths`` as one JSON
    record: ``analyze_images_batch``, ``filter_interior_images`` (paths and
    confidences) and ``analyze_image_from_url`` on ``broken``."""
    interior, non_interior = eng.filter_interior_images(paths)
    return {"batch": eng.analyze_images_batch(paths, filter_interiors=False),
            "interior": [(p, conf) for p, _px, conf in interior],
            "non_interior": non_interior,
            "url": eng.analyze_image_from_url(broken, filter_interiors=False)}


def case_analyzer_paths(mesh, d, c):
    """The int8 engine on files under the mesh, where rank 1 alone cannot
    read one of them (its fetch and its image load fail on that path):
    rank 0 reads and decodes for every rank. The engine writes the text
    cache."""
    import torch
    import torch.distributed as dist

    from aiic_tpu_torch.data import pipeline
    from aiic_tpu_torch.engine import analyzer as engine_mod
    from aiic_tpu_torch.models.config import TINY_TEST

    paths = [os.path.join(d, p) for p in c["paths"]]
    broken = paths[c["broken"]]
    if dist.get_rank() == 1:
        fetch, load_image = pipeline.fetch_source, engine_mod.load_image
        pipeline.fetch_source = lambda s: b"" if s == broken else fetch(s)
        engine_mod.load_image = lambda s: None if s == broken else load_image(s)
    eng = engine_mod.InteriorAnalyzer(
        _tree(os.path.join(d, "params.npz")), TINY_TEST, training_data=TRAINING,
        dtype=torch.bfloat16, quantize=True, max_batch=c["max_batch"], device="cpu", mesh=mesh,
        text_cache=os.path.join(d, c["cache"]))
    return {"record": np.asarray(json.dumps(serving_record(eng, paths, broken))),
            "det_text": eng.det_text, "cat_text": eng.cat_text}


def _http(port: int, method: str, path: str, body: bytes = None) -> tuple:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _serve_requests(port: int, blobs: list, urls: list) -> dict:
    """The requests of the serving case: each blob alone in turn, then 16
    concurrently, then one /analyze-batch of URLs and base64 blobs."""
    import base64
    import threading

    out = {"sequential": [_http(port, "POST", "/analyze", b) for b in blobs]}
    concurrent = [None] * 16

    def one(i):
        concurrent[i] = _http(port, "POST", "/analyze", blobs[i % len(blobs)])
    threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    out["concurrent"] = concurrent
    out["batch"] = _http(port, "POST", "/analyze-batch", json.dumps(
        {"urls": urls, "images_b64": [base64.b64encode(b).decode() for b in blobs]}).encode())
    return out


def case_serve(mesh, d, c):
    """The worker over the world: rank 0's serving app on the engine lane
    (``parallel.lane``) at pipeline depths 0 and 2, then a batch deadline
    that expires while the warmup holds the lane, then the one-shot drain
    through ``cli.worker.run_rank``; the other ranks follow."""
    import threading

    import torch.distributed as dist

    from aiic_tpu_torch.cli import worker as cli_worker
    from aiic_tpu_torch.engine.analyzer import InteriorAnalyzer
    from aiic_tpu_torch.models.config import TINY_TEST
    from aiic_tpu_torch.parallel.lane import EngineLane
    from aiic_tpu_torch.serve.app import build_serving_app
    from aiic_tpu_torch.serve.db import InMemoryDB

    eng = InteriorAnalyzer(_tree(os.path.join(d, "params.npz")), TINY_TEST,
                           training_data=TRAINING, max_batch=8, device="cpu", mesh=mesh)
    lead = dist.get_rank() == 0
    blobs = []
    for name in c["blobs"]:
        with open(os.path.join(d, name), "rb") as f:
            blobs.append(f.read())
    urls = [os.path.join(d, p) for p in c["urls"]]
    out = {}
    lane = EngineLane(eng, log=lambda *_: None)
    if not lead:
        out["follow_rc"] = lane.follow()
    else:
        try:
            for depth in (0, 2):
                server, batcher, _ = build_serving_app(
                    lane, port=0, max_batch=8, pipeline_depth=depth, warm_async=False,
                    max_batch_items=16, log=lambda *_: None)
                threading.Thread(target=server.serve_forever, daemon=True).start()
                try:
                    out[f"depth{depth}"] = _serve_requests(server.server_address[1], blobs, urls)
                finally:
                    server.shutdown()
                    batcher.close()
            # the warmup holds the lane past the request's deadline
            warmup = eng.warmup

            def slow_warmup(sizes):
                time.sleep(c["hold_s"])
                warmup(sizes)
            eng.warmup = slow_warmup
            server, batcher, warmed = build_serving_app(
                lane, port=0, max_batch=8, request_timeout=c["timeout_s"], warm_async=True,
                log=lambda *_: None)
            threading.Thread(target=server.serve_forever, daemon=True).start()
            port = server.server_address[1]
            try:
                t0 = time.monotonic()
                status, body = _http(port, "POST", "/analyze", blobs[0])
                timed_out = {"status": status, "seconds": time.monotonic() - t0, "body": body}
                warmed.wait(60)
                out["timeout"] = {"first": timed_out, "next": _http(port, "POST", "/analyze",
                                                                     blobs[0])}
            finally:
                server.shutdown()
                batcher.close()
                eng.warmup = warmup
        finally:
            lane.close()
    db = None
    if lead:
        os.chdir(d)  # the drain's export lands beside the inputs
        db = InMemoryDB()
        db.insert_apartment("a1", title="t1")
        db.insert_apartment("a2", title="t2")
        for i, p in enumerate(c["drain"]):
            db.insert_image(f"i{i}", "a1" if i < 3 else "a2", os.path.join(d, p))
    args = cli_worker.build_parser().parse_args(["--batch-size", "4", "--device", "cpu"])
    out["drain_rc"] = cli_worker.run_rank(args, eng, db, log=lambda *_: None)
    if lead:
        out["serving"] = json.dumps({k: out.pop(k) for k in ("depth0", "depth2", "timeout")})
        with open("analysis_export.json", encoding="utf-8") as f:
            export = json.load(f)
        out["drain"] = json.dumps({"images": db.images, "export": export}, default=str)
    return {k: np.asarray(v) for k, v in out.items()}


class _Recording:
    """The trainer's optimizer, keeping the gradients each update receives."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, tree):
        return self.opt.init(tree)

    def update(self, grads, state, params, norm_sq=None):
        self.grads = grads
        return self.opt.update(grads, state, params, norm_sq)


def case_train(mesh, d, c):
    """``shard_train_step`` over the mesh, one step (and a second that must
    run): loss, the adapters and the gradients, whole."""
    import torch

    from aiic_tpu_torch.models.config import TINY_TEST
    from aiic_tpu_torch.ops.quant import quantize_model_mlp
    from aiic_tpu_torch.parallel import shard_train_step
    from aiic_tpu_torch.parallel.sharding import distribute_tree, full_tree, lora_pspecs
    from aiic_tpu_torch.train import trainer

    params = _tree(os.path.join(d, "params.npz"))
    lora = _tree(os.path.join(d, "lora.npz"))
    tc = trainer.TrainConfig(**c["cfg"])
    if tc.quantize_image:
        params = quantize_model_mlp(params, attn=True, towers=("visual",))
    opt = _Recording(trainer.make_optimizer(tc, 1))
    ins = np.load(os.path.join(d, c["inputs"]))
    pool = ins["pool"] if "pool" in ins.files else None
    layout = dict(replicate_visual=c["replicate_visual"], replicate_text=c["replicate_text"])
    ts, es = trainer.make_train_step(TINY_TEST, tc, opt, mesh=mesh, prompt_pool=pool,
                                     device="cpu", **layout)
    jt, _, sp, sl, so = shard_train_step(mesh, ts, es, params, lora, opt.init(lora), **layout)
    gen = (torch.Generator().manual_seed(c["dropout_seed"]) if "dropout_seed" in c else None)
    x, t = torch.from_numpy(ins["x"]), torch.from_numpy(ins["tokens"])
    loss, new_lora, new_opt = jt(sp, sl, so, x, t, gen)
    grads = full_tree(distribute_tree(opt.grads, lora_pspecs(lora, replicate=c["replicate_text"]),
                                      mesh))
    loss2, _, _ = jt(sp, new_lora, new_opt, x, t, gen)
    return {"loss": loss, "loss2": loss2, "lora": _flat(full_tree(new_lora)),
            "grads": _flat(grads), "text_impl": np.asarray(ts.text_impl)}


def case_seam(mesh, d, c):
    """The input seam: this rank loads only its rows (``process_local_rows``)
    and feeds them through ``host_local_batch`` to the mesh's step."""
    from aiic_tpu_torch.models.config import TINY_TEST
    from aiic_tpu_torch.parallel import shard_train_step
    from aiic_tpu_torch.parallel.multihost import (
        global_batch_size, host_local_batch, process_local_rows, replicated,
    )
    from aiic_tpu_torch.train import trainer

    params = _tree(os.path.join(d, "params.npz"))
    lora = _tree(os.path.join(d, "lora.npz"))
    tc = trainer.TrainConfig(**c["cfg"])
    opt = trainer.make_optimizer(tc, 1)
    ts, es = trainer.make_train_step(TINY_TEST, tc, opt, mesh=mesh, device="cpu",
                                     replicate_visual=True, replicate_text=False)
    jt, je, sp, sl, so = shard_train_step(mesh, ts, es, params, lora, opt.init(lora))
    ins = np.load(os.path.join(d, c["inputs"]))
    rows = process_local_rows(np.arange(len(ins["x"])), mesh)
    x, t = host_local_batch(mesh, ins["x"][rows]), host_local_batch(mesh, ins["tokens"][rows])
    loss, _, _ = jt(sp, sl, so, x, t)
    r = replicated(mesh, ins["tokens"])
    return {"loss": loss, "eval": je(sp, sl, x, t), "rows": rows,
            "global_shape": np.asarray(x.shape), "local_rows": np.asarray(x.to_local().shape[0]),
            "global_batch": np.asarray(global_batch_size(mesh, len(rows))),
            "replicated": r.to_local()}


def case_train_lora(mesh, d, c):
    """``train_lora`` over the mesh on the synthetic dataset, counting the
    outputs this rank writes."""
    from aiic_tpu_torch.models.config import TINY_TEST
    from aiic_tpu_torch.train import checkpoint, trainer

    writes = []

    def counted(real, name):
        def call(*a, **k):
            writes.append(name)
            return real(*a, **k)
        return call
    for mod, name in ((trainer, "save_lora_pth"), (checkpoint, "save_train_state")):
        setattr(mod, name, counted(getattr(mod, name), name))
    out = trainer.train_lora(os.path.join(d, c["json"]), os.path.join(d, c["save"]),
                             params=_tree(os.path.join(d, "params.npz")), config=TINY_TEST,
                             cfg=trainer.TrainConfig(**c["cfg"]), mesh=mesh, device="cpu",
                             log=lambda *_: None)
    return {"train_loss": np.asarray([h["train_loss"] for h in out["history"]]),
            "val_loss": np.asarray([h["val_loss"] for h in out["history"]]),
            "writes": np.asarray(len(writes)), "lora": _flat(out["lora_tree"])}


CASES = {"encode": case_encode, "classify": case_classify, "analyzer": case_analyzer,
         "analyzer_paths": case_analyzer_paths, "train": case_train, "seam": case_seam,
         "train_lora": case_train_lora, "serve": case_serve}


def main(plan_path: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(plan_path) as f:
        plan = json.load(f)
    d, world = plan["dir"], plan["world"]
    # a collective that waits a minute on a failed rank fails too
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(d, "store"), world),
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    from aiic_tpu_torch.parallel import create_mesh

    for c in plan["cases"]:
        mesh = create_mesh(world, tp=c.get("tp", 1), device="cpu")
        out = CASES[c["case"]](mesh, d, c)
        np.savez(os.path.join(d, f"{c['name']}_{rank}.npz"), **_flat(_np(out)))
    dist.barrier()
    assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
    assert not [m for m in sys.modules if m == "aiic_tpu" or m.startswith("aiic_tpu.")]
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
