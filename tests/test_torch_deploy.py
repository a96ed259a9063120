"""The GPU worker image of the port (``deploy/Dockerfile.torch_worker``,
``deploy/docker-compose.torch.yml``), checked statically: nothing is built
here. Every ``COPY`` source exists in the repository, every module a
``CMD`` or a compose ``command`` runs resolves, the compose file builds the
port's Dockerfile and reserves a card for each service that runs it, and
nothing of the JAX package is copied or run."""

import importlib.util
import json
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCKERFILE = os.path.join(REPO, "deploy", "Dockerfile.torch_worker")
COMPOSE = os.path.join(REPO, "deploy", "docker-compose.torch.yml")


def _lines(path):
    with open(path, encoding="utf-8") as f:
        return [ln.rstrip("\n") for ln in f if not ln.lstrip().startswith("#")]


def _modules(cmd: list) -> list:
    return [cmd[i + 1] for i, a in enumerate(cmd[:-1]) if a == "-m"]


def _compose_services() -> dict:
    """{service: its lines} of the compose file's ``services:`` block."""
    services, name = {}, None
    for ln in _lines(COMPOSE):
        if ln.startswith("volumes:"):
            break
        m = re.match(r"^  (\w+):$", ln)
        if m:
            name = m.group(1)
            services[name] = []
        elif name:
            services[name].append(ln)
    return services


def test_dockerfile_copies_existing_sources_and_runs_the_port():
    copies = [ln.split()[1:-1] for ln in _lines(DOCKERFILE) if ln.startswith("COPY ")]
    assert copies, "no COPY"
    sources = [s for c in copies for s in c]
    assert [s for s in sources if not os.path.exists(os.path.join(REPO, s))] == []
    assert "aiic_tpu_torch" in sources and "native" in sources
    assert not any(s == "aiic_tpu" or s.startswith("aiic_tpu/") for s in sources)
    (cmd,) = [json.loads(ln[len("CMD "):]) for ln in _lines(DOCKERFILE) if ln.startswith("CMD ")]
    assert _modules(cmd) == ["aiic_tpu_torch.cli.worker"]
    assert re.search(r"^FROM nvidia/cuda:[\w.]+-devel", "\n".join(_lines(DOCKERFILE)), re.M)
    assert "jax" not in "\n".join(_lines(DOCKERFILE)).lower()


@pytest.mark.parametrize("service", ["api", "worker"])
def test_compose_service_runs_the_port_on_a_card(service):
    body = "\n".join(_compose_services()[service])
    assert "dockerfile: deploy/Dockerfile.torch_worker" in body
    assert "capabilities: [gpu]" in body
    (cmd,) = [json.loads(m) for m in re.findall(r"command: (\[.*?\])", body, re.S)]
    mods = _modules(cmd)
    assert mods == ["aiic_tpu_torch.cli.worker"]
    assert all(importlib.util.find_spec(m) is not None for m in mods)


def test_compose_keeps_the_three_services():
    assert list(_compose_services()) == ["mongo", "api", "worker"]
    mounted = [ln.split(":")[0].strip(" -") for ln in _compose_services()["mongo"]
               if "init-mongo.js" in ln]
    assert mounted and all(os.path.exists(os.path.join(REPO, "deploy", m)) for m in mounted)
