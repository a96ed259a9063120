"""Platform selection — the port of ``aiic_tpu.utils.platform``.

``AIIC_PLATFORM=cpu|cuda`` names the device the CLIs run on when no
``--device`` is given (``apply_platform_env``, called where each CLI
builds its parser), as if the caller had passed it: ``cuda`` without a
card fails, nothing falls back to the CPU. With no value the CLIs run on
``cuda``.

The JAX package's ``AIIC_CPU_DEVICES`` (N virtual CPU devices in one
process) has no counterpart: a torch mesh of N is N ranks, one process
each (``parallel.mesh``). ``enable_compilation_cache`` (XLA's persistent
compilation cache) is not ported either: the kernels' nvcc build already
persists, keyed by a hash of their sources, under
``aiic_tpu_torch/_build/``.
"""

from __future__ import annotations

import os

PLATFORMS = ("cpu", "cuda")


def apply_platform_env() -> str:
    """The CLIs' ``--device`` default: ``$AIIC_PLATFORM``, else ``cuda``."""
    plat = os.environ.get("AIIC_PLATFORM") or "cuda"
    if plat not in PLATFORMS:
        raise ValueError(f"AIIC_PLATFORM={plat!r}: the port runs on one of {PLATFORMS}")
    return plat


def require_device(device: str):
    """``torch.device(device)``; exits with the reason when it names CUDA
    and no card is visible: nothing falls back to the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: no CUDA device is visible; the port runs on "
                         "the card (pass --device cpu for the plain CPU path)")
    return dev


def device_line(device) -> str:
    """The device a measurement ran on: for a card its name and power limit
    as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them (the name alone where nvidia-smi is missing), else "cpu"."""
    import subprocess

    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    index = torch.cuda.current_device() if dev.index is None else dev.index
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"
