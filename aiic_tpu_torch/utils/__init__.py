"""Host-side helpers of the port (copies of JAX-free ``aiic_tpu.utils``
modules, under its names; XLA's persistent compilation cache,
``enable_compilation_cache``, has no counterpart)."""

from aiic_tpu_torch.utils.batching import bucket_size, pad_batch
from aiic_tpu_torch.utils.profiling import StageTimer

__all__ = ["bucket_size", "pad_batch", "StageTimer"]
