"""Multi-device serving and training on torch.distributed — the port of
``aiic_tpu.parallel``: ``("data", "model")`` device meshes (``mesh``), the
data-parallel input seam (``multihost``), the sharding rules, the
tensor-parallel block and the sharded classify and train programs
(``sharding``)."""

from aiic_tpu_torch.parallel.mesh import create_mesh, mesh_shape_for
from aiic_tpu_torch.parallel.sharding import (
    lora_pspecs,
    make_sharded_classify_fn,
    param_pspecs,
    shard_params,
    shard_train_step,
)

__all__ = [
    "create_mesh",
    "mesh_shape_for",
    "param_pspecs",
    "lora_pspecs",
    "shard_params",
    "shard_train_step",
    "make_sharded_classify_fn",
]
