"""The benchmark at a size a CPU test run holds: every width cut, the
program on its plain CPU path."""

from __future__ import annotations

from pathlib import Path

from h100_bench import harness

ROOT = Path(__file__).resolve().parents[2]
TINY = {"image_size": 32, "patch_size": 8, "vision_width": 64, "vision_layers": 2,
        "vision_heads": 4, "text_width": 32, "text_layers": 2, "text_heads": 4,
        "vocab_size": 512, "context_length": 16, "embed_dim": 32}
TRAFFIC = {"closed_loop": {"pool": 32, "outstanding": 12, "max_batch": 4, "max_queue": 32,
                           "check_rows": 8},
           "offline": {"pool": 32, "batch": 8, "check_rows": 8},
           "train_step": {"pool": 32, "batch": 8}}
# float32 engines at the tiny size agree with the reference to round-off
FP32 = {"engine": {"dtype": "float32", "quantize": False, "wire_format": "hwc",
                   "attn_impl": "auto"}}
ANSWERS = {"prob_gap": 1e-3, "logit_err": 1e-2, "kl": 1e-5, "feat_err": 1e-5}
LIMITS = {"offline": ANSWERS, "closed_loop": ANSWERS,
          "train_step": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}}


def traffic_of(workload: str, root: Path = ROOT) -> str:
    bench = harness.load_benchmark(root)
    w = next(x for x in bench["workloads"] if x["name"] == workload)
    return harness.load_json(root, f"h100_bench/traffic/{w['traffic']}.json")["kind"]


def run(workload: str, seed: int = 3000000019, trace: int = 0, cfg=None, control=None,
        root: Path = ROOT, seconds: float = 0.5):
    kind = traffic_of(workload, root)
    over = {"cfg": {**TINY, **(cfg or {})}, "traffic": TRAFFIC[kind]}
    return harness.run(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                        "--trace", str(trace)], root=root, device="cpu", overrides=over,
                       control=control, log=lambda msg: None)
