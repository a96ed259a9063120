"""The port's quickstart (``examples/torch_quickstart.py``) and REST smoke
(``tools/torch_rest_smoke.py``) on a synthetic reference tree at TINY_TEST on
the CPU: labelled images, a sample JPEG and a seeded rank-4 reference-layout
``comprehensive_lora.pth`` (the reference tree itself is not in the
repository).

The quickstart's steps against the JAX engine on the same weights, carried
into the port through the parameter bridge: the detector verdict and the
first file's top style and room equal; their confidences within 2e-2, since
the JAX engine runs bf16 with XLA's excess precision (fp32 intermediates)
and the port rounds to bf16 where the program does (about 1e-2 apart at
this width); the prints in the JAX quickstart's order.
"""

import importlib.util
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from aiic_tpu.engine import InteriorAnalyzer as JaxAnalyzer
from aiic_tpu.models.config import TINY_TEST as JAX_TINY
from aiic_tpu.models.init import flatten_params, init_clip_params
from aiic_tpu_torch.models.config import TINY_TEST
from aiic_tpu_torch.models.init import params_from_numpy
from torch_reference import make_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF_TOL = 2e-2


def _load(relpath: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The synthetic reference tree of ``tests/torch_reference.py``."""
    return make_reference(tmp_path_factory.mktemp("reference"))


def test_quickstart_steps_match_jax(reference, tmp_path):
    quickstart = _load("examples/torch_quickstart.py", "torch_quickstart")
    jp = init_clip_params(jax.random.PRNGKey(3), JAX_TINY)
    lines = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # loaded weights with the hermetic vocabulary
        out = quickstart.run(str(reference), config=TINY_TEST,
                             params=params_from_numpy(flatten_params(jp)), device="cpu",
                             save_path=str(tmp_path / "adapters.pth"), log=lines.append)
        ref = JaxAnalyzer(jp, JAX_TINY, dataset_json=str(reference / "interior_dataset.json"),
                          use_lora=True,
                          lora_weights_path=str(reference / "lora_models" /
                                                "comprehensive_lora.pth"),
                          dtype=jnp.bfloat16)
    want = ref.is_interior_image(Image.open(reference / "interior_sample.jpg"))
    got = out["verdict"]
    assert (got[0], got[2]) == (want[0], want[2])
    assert abs(got[1] - want[1]) <= CONF_TOL
    paths = out["paths"]
    assert len(paths) == 8
    jres = ref.analyze_images_batch(paths[:1], filter_interiors=False)[paths[0]]
    one = out["results"][paths[0]]
    for cat in ("styles", "room_types"):
        assert one["analysis"][cat][0][0] == jres["analysis"][cat][0][0]
        assert abs(one["analysis"][cat][0][1] - jres["analysis"][cat][0][1]) <= CONF_TOL
    assert np.isfinite(out["best_val_loss"]) and (tmp_path / "adapters.pth").exists()
    assert out["rest"]["detected_category"] and len(out["rest_batch"]) == 3
    assert "analyze_p50_ms" in out["metrics"]
    assert [ln.split(":")[0] for ln in lines if ln.split(":")[0] in (
        "engine ready", "detector", "top style", "trained", "REST verdict", "REST batch",
        "live p50")] == ["engine ready", "detector", "top style", "trained", "REST verdict",
                         "REST batch", "live p50"]


def test_rest_smoke_tool_ends_ok(reference):
    """``tools/torch_rest_smoke.py`` as a process against the worker on the
    CPU at TINY_TEST: its JSON line, the JAX tool's fields, all checks
    true."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "OMP_NUM_THREADS": "2", "CUDA_VISIBLE_DEVICES": ""}
    run = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_rest_smoke.py"), str(port),
         "--dataset-json", str(reference / "interior_dataset.json"),
         "--sample", str(reference / "interior_sample.jpg"),
         "--device", "cpu", "--model", "tiny", "--text-cache", "none", "--max-batch", "8"],
        capture_output=True, text=True, timeout=120, env=env)
    assert run.returncode == 0, run.stderr[-2000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert line["metric"] == "rest_first_request_after_ready_ms"
    for k in ("no_cold_start_stall", "full_reference_schema", "dead_letters_queryable",
              "latency_quantiles_present", "stages_present"):
        assert line[k] is True, k
    assert line["batch_results"] == 4
