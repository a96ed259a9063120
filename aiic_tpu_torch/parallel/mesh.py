"""Device meshes on torch.distributed — the port of ``aiic_tpu.parallel.mesh``.

The port parallelizes as the JAX package does, over a 2-D ``("data",
"model")`` mesh:

- ``data``: batch sharding (pure data parallelism), the axis that matters
  for this workload;
- ``model``: Megatron tensor parallelism over attention heads and MLP
  hidden columns (``parallel.sharding``), wired end to end for the wider
  towers (ViT-L/14).

The idiom is one process per device, as under ``torchrun``: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of ranks, laid out row-major
into ``(dp, tp)`` as JAX lays out ``np.asarray(devices).reshape(dp, mp)``.
A mesh of N needs a world of N ranks; a plain process is a world of one.

:func:`create_mesh` sets up the default process group when the caller has
not: from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), else as a group of one on
an in-process store. A rank's device is ``cuda:{LOCAL_RANK %
device_count}`` unless the caller passes ``device="cpu"``; the backend is
``nccl`` on the card and ``gloo`` on the CPU unless the caller passes
``backend=``. NCCL takes one card per rank, so two ranks sharing a card
under ``nccl`` are refused before NCCL's own error; ``backend="gloo"``
shares a card. Nothing changes backend or device on its own.
"""

from __future__ import annotations

import os
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("data", "model")
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def mesh_shape_for(n_devices: int, tp: Optional[int] = None) -> Tuple[int, int]:
    """Factor n into (data, model). Default: model axis 2 when even and >2
    devices (exercises TP collectives), else pure DP."""
    if tp is None:
        tp = 2 if (n_devices % 2 == 0 and n_devices > 2) else 1
    if n_devices % tp != 0:
        raise ValueError(f"{n_devices} devices not divisible by tp={tp}")
    return n_devices // tp, tp


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given, else
    ``cuda:{LOCAL_RANK % device_count}``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; a mesh runs on the card unless the "
                           "caller passes device='cpu'")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())


def _refuse_shared_card(backend: str, world: int) -> None:
    if backend != "nccl":
        return
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cards = torch.cuda.device_count()
    if local > cards:
        raise ValueError(
            f"{local} ranks on this host share {cards} CUDA device(s): NCCL takes one card "
            f"per rank; pass backend=\"gloo\" to run ranks that share a card")


def init_world(backend: Optional[str] = None, device=None) -> torch.device:
    """The default process group (set up here when the caller has not) and
    this rank's device, made current on the card."""
    dev = rank_device(device)
    if dist.is_initialized():
        _refuse_shared_card(dist.get_backend(), dist.get_world_size())
    else:
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        from_env = all(k in os.environ for k in TORCHRUN_ENV)
        _refuse_shared_card(backend, int(os.environ["WORLD_SIZE"]) if from_env else 1)
        if from_env:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # before NCCL binds its communicators
    return dev


def create_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None,
                devices: Optional[Sequence[int]] = None, *, backend: Optional[str] = None,
                device=None) -> DeviceMesh:
    """A ``("data", "model")`` mesh of ``n_devices`` ranks (default: the
    world), ``tp`` of them on the model axis (``mesh_shape_for``).
    ``devices`` orders the ranks (default: rank order)."""
    dev = init_world(backend, device)
    world = dist.get_world_size()
    ranks = list(devices if devices is not None else range(world))
    if n_devices is not None:
        if len(ranks) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(ranks)}")
        ranks = ranks[:n_devices]
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"a mesh of {len(ranks)} needs a world of {len(ranks)} ranks, one "
                         f"process per device (torchrun --nproc-per-node {len(ranks)}); the "
                         f"world has {world}")
    dp, mp = mesh_shape_for(len(ranks), tp)
    return DeviceMesh(dev.type, torch.tensor(ranks).reshape(dp, mp), mesh_dim_names=AXES)


# ---------------------------------------------------------------------------
# Where this rank sits, and the collectives the sharded programs use
# ---------------------------------------------------------------------------


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of t over ``group`` (a new tensor)."""
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every member's t concatenated along ``dim`` in group-rank order."""
    t = t.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def all_gather_start(t: torch.Tensor, group, dim: int = 0) -> Callable[[], torch.Tensor]:
    """Issue :func:`all_gather` without waiting for it: the returned call
    waits and concatenates. A caller that must issue collectives in one
    order on every rank can wait for them elsewhere."""
    t = t.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    work = dist.all_gather(parts, t, group=group, async_op=True)

    def wait() -> torch.Tensor:
        work.wait()
        return torch.cat(parts, dim=dim)
    return wait


def from_rank0(fn: Callable[[], Any]) -> Any:
    """``fn()`` run by rank 0 alone, its value (any picklable object) on
    every rank of the world. What rank 0 raises is raised on every rank, so
    no rank waits on a collective that the others never reach."""
    box: List[Any] = [None]
    error = None
    if dist.get_rank() == 0:
        try:
            box[0] = (fn(), None)
        except Exception as e:  # every rank learns of it before rank 0 raises
            error = e
            box[0] = (None, f"{type(e).__name__}: {e}")
    dist.broadcast_object_list(box, src=0)
    if error is not None:
        raise error
    value, message = box[0]
    if message is not None:
        raise RuntimeError(f"rank 0 failed: {message}")
    return value
