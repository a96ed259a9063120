"""One run of one cell: look the cell up in ``BENCHMARK.json``, find its
configuration, traffic mix and per-layer metrics by name, drive the program
through the traffic's runner, read the metrics, decide ``correct`` against
the plain reference, and build the result line.

A later cell, mix or metric is files and entries: the configuration is
``configs/<name>.json`` (named by the entry's ``file``), the mix
``traffic/<name>.json``, the runner of the mix's ``kind``
``kinds/<kind>.py`` (``generator`` says what it defines), each per-layer
metric ``metrics/<name>.py`` with a ``read(run)`` that returns a number or
None. No file here names a cell or a kind.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aiic_tpu")


def process_start() -> float:
    """The process's start on ``time.time()``'s clock (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``aiic_tpu_torch`` is not ``aiic_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(root: Path, rel: str) -> dict:
    with open(root / rel) as f:
        return json.load(f)


def cell(bench: dict, root: Path, workload: str):
    """(workload entry, configuration, traffic mix) found by name."""
    try:
        w = next(x for x in bench["workloads"] if x["name"] == workload)
    except StopIteration:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json") from None
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg = load_json(root, entry["file"])
    traffic = load_json(root, f"{HERE.relative_to(root)}/traffic/{w['traffic']}.json")
    return w, cfg, traffic


def metrics_for(bench: dict, key: str, workload: str, reported=()) -> List[dict]:
    """The cell's metrics of ``key`` ("end_to_end" or "per_layer"): those
    that list it, or list no cells and move an end-to-end metric it
    reports."""
    out = []
    for m in bench[key]:
        cells = m.get("workloads")
        if cells is not None:
            if workload in cells:
                out.append(m)
        elif key == "end_to_end" or m.get("moves") in reported:
            out.append(m)
    return out


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Marker:
    """The window's range in the trace (``trace.WINDOW``)."""

    def __init__(self, tracing: bool):
        self.tracing = tracing
        self.rf = None
        self.host_start = None

    def start(self) -> None:
        self.host_start = time.perf_counter()
        if self.tracing:
            import torch

            from h100_bench.trace import WINDOW

            self.rf = torch.profiler.record_function(WINDOW)
            self.rf.__enter__()

    def end(self) -> None:
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None


class RunRecord:
    """What a per-layer metric's reader reads."""

    def __init__(self, cfg, traffic, engine, train, out, trace):
        self.cfg, self.traffic, self.engine, self.train = cfg, traffic, engine, train
        self.window_s = out["window_s"]
        self.e2e = out["e2e"]
        self.images = out["images"]
        self.steps = out.get("steps", 0)
        self.counters = out["counters"]
        self.traced_calls = out["traced_calls"]
        self.trace = trace


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m h100_bench.run",
                                description="Run one benchmark cell on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(argv, *, root: Path = HERE.parent, device: str = "cuda", overrides: Optional[dict] = None,
        control: Optional[str] = None, log=None, numbers_out: Optional[dict] = None):
    """One run; returns (exit code, result dict or None). ``device`` "cpu"
    and ``overrides`` (``{"cfg": {...}, "traffic": {...}}`` merged over the
    files) are for the tests; ``control`` "engine", "train" or "reference"
    puts the configuration's control in the program's place;
    ``numbers_out`` receives every number the comparison worked out, the
    compared ones and the statistics beside them."""
    t_start = process_start()
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    args = parse(argv)
    bench = load_benchmark(root)
    w, cfg, traffic = cell(bench, root, args.workload)
    overrides = overrides or {}
    cfg = {**cfg, **overrides.get("cfg", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}

    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            log(f"this cell needs {w['chips']} CUDA device(s); {found} visible")
            return 2, None
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(device)

    from h100_bench.generator import Context, load_kind
    from h100_bench.trace import Spans, Tracer

    engine = dict(cfg.get("engine", {}))
    train = dict(cfg["train"]) if "train" in cfg else None
    if control == "engine":
        engine.update(cfg["control"]["engine"])
    elif control == "train":
        train.update(cfg["control"]["train"])
    tracing = bool(args.trace)
    spans = Spans()
    ctx = Context(cfg, traffic, args.seed, dev, spans, engine, train)
    runner = load_kind(traffic["kind"]).Runner(ctx)
    t_setup = time.time()
    runner.setup()
    setup_s = time.time() - t_start
    parts = {}
    for name, a, b in spans.records:
        if name.startswith("setup."):
            parts[name[6:]] = parts.get(name[6:], 0.0) + (b - a)
    log(f"setup_s {setup_s:.3f}: to the runner {t_setup - t_start:.3f}, "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))

    tracer = Tracer(tracing, dev)
    tracer.start()
    marker = Marker(tracing)
    out = runner.window(args.seconds, marker)
    out.update(runner.finish() or {})
    t_stop = time.perf_counter()
    tracer.stop()
    t_stopped = time.perf_counter()
    found = forbidden_modules()
    if found:
        log(f"loaded in this process after the window: {', '.join(found)}")
        return 3, None
    log(f"window {out['window_s']:.6f} s, e2e {json.dumps(out['e2e'])}, "
        f"counters {json.dumps(out['counters'])}")
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    summary = tracer.summary(spans, marker.host_start)
    if summary is not None:
        log(f"trace: stopped in {t_stopped - t_stop:.3f} s, reduced in "
            f"{time.perf_counter() - t_stopped:.3f} s")
        log(f"trace: {len(out['traced_calls'])} calls or steps traced; launches "
            + ", ".join(f"{k} {summary.launches(k)} ({summary.device_s(k):.6f} s)"
                        for k in ("wgmma_stage_kernel", "attn_core_mma_kernel")))
    record = RunRecord(cfg, traffic, engine, train, out, summary)

    e2e = metrics_for(bench, "end_to_end", w["name"])
    metrics: Dict[str, Any] = {}
    if tracing:
        reported = {m["name"] for m in e2e}
        for m in metrics_for(bench, "per_layer", w["name"], reported):
            value = reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            value = setup_s if m["name"] == "setup_s" else out["e2e"].get(m["name"])
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the comparison, once the program's state is freed
    numbers = runner.compare(control)
    del runner
    if numbers_out is not None:
        numbers_out.update(numbers)
    # the configuration's limits for the mix's kind, or for the kind the mix names as its
    # comparison's (a mix of a new kind whose runner compares as an existing kind does)
    limits = cfg.get("limits", {}).get(traffic.get("limits", traffic["kind"]), {})
    compared = {k: {"value": numbers[k], "limit": v} for k, v in limits.items() if k in numbers}
    correct = bool(out["attempted"] > 0 and compared and all(
        math.isfinite(c["value"]) and c["limit"] is not None and c["value"] <= c["limit"]
        for c in compared.values()))

    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": _device(dev, w["chips"], peak, summary)}
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["compared"] = compared
    for k, c in compared.items():
        log(f"compared {k} {c['value']!r} limit {c['limit']!r}")
    return 0, result


def _device(dev, chips: int, peak: int, summary) -> dict:
    import torch

    if dev.type == "cuda":
        d = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
             "memory_peak_bytes": peak}
    else:
        d = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    if summary is not None:
        d["busy_s"] = summary.busy_s
        d["window_s"] = summary.window_s
    return d


def main(argv=None) -> int:
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ.setdefault("USE_TF", "0")
    code, result = run(sys.argv[1:] if argv is None else argv)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code
