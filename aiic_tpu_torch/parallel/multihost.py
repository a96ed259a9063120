"""Data-parallel input placement — the port of ``aiic_tpu.parallel.multihost``.

Each rank loads only its shard of the global batch: the rows of its
coordinate on the mesh's ``"data"`` axis (ranks that differ only on
``"model"`` load the same rows). :func:`host_local_batch` makes that shard
the ``Shard(0)`` piece of a global ``DTensor``, which never exists whole on
any rank. A world of one flows through the same calls: its local rows are
the global batch.

    mesh = create_mesh(...)
    rows = process_local_rows(global_indices, mesh)   # this rank's rows only
    batch = host_local_batch(mesh, load(rows))
    loss, lora, opt_state = train_step(params, lora, opt_state, batch, tokens)

Where JAX speaks of a process (a host with its local devices), the port
speaks of a rank of the ``"data"`` axis: one process per device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from aiic_tpu_torch.parallel.mesh import mesh_device


def _process_count(mesh: Optional[DeviceMesh] = None) -> int:
    """Ranks that load disjoint rows: the mesh's ``"data"`` size, else the
    world's size."""
    if mesh is not None:
        return mesh.size(0)
    return dist.get_world_size() if dist.is_initialized() else 1


def _process_index(mesh: Optional[DeviceMesh] = None) -> int:
    """This rank's coordinate on ``"data"``, else its rank in the world."""
    if mesh is not None:
        return mesh.get_local_rank("data")
    return dist.get_rank() if dist.is_initialized() else 0


def global_batch_size(mesh: DeviceMesh, local_batch: int) -> int:
    """Global batch implied by a per-rank batch under ``"data"`` sharding."""
    return local_batch * _process_count(mesh)


def _tensor(data, mesh: DeviceMesh) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data.to(mesh_device(mesh))
    return torch.from_numpy(np.ascontiguousarray(data)).to(mesh_device(mesh))


def host_local_batch(mesh: DeviceMesh, local_data,
                     spec: Optional[Sequence[Placement]] = None) -> DTensor:
    """This rank's rows (shape ``(global_batch / dp, ...)``) as their piece
    of the global batch, ``[Shard(0), Replicate()]`` over ``("data",
    "model")``. Every rank calls it with its own rows."""
    spec = (Shard(0), Replicate()) if spec is None else tuple(spec)
    return DTensor.from_local(_tensor(local_data, mesh), mesh, spec, run_check=False)


def process_local_rows(global_rows, mesh: Optional[DeviceMesh] = None):
    """THIS rank's shard of a global batch's rows (or indices).

    The data-parallel contract is two-sided: every rank passes its own
    disjoint ``global_batch / dp`` rows to :func:`host_local_batch`, which
    assembles the global batch. Feeding the full global batch from every
    rank would duplicate each row ``dp`` times, and under the contrastive
    loss each duplicate on another rank is a labeled NEGATIVE with cosine
    1.0, silently degenerating training. One data rank: identity."""
    n = _process_count(mesh)
    if n == 1:
        return global_rows
    b = len(global_rows)
    if b % n:
        raise ValueError(f"global batch {b} not divisible by process_count {n}")
    shard = b // n
    i = _process_index(mesh)
    return global_rows[i * shard:(i + 1) * shard]


def replicated(mesh: DeviceMesh, data) -> DTensor:
    """Small host data (token tables, text caches) replicated on the mesh.
    Every rank passes identical values."""
    return DTensor.from_local(_tensor(data, mesh), mesh, (Replicate(), Replicate()),
                              run_check=False)
