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
