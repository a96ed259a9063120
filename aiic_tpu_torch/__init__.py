"""aiic_tpu_torch — the PyTorch/CUDA port of ``aiic_tpu`` for NVIDIA Hopper.

The JAX package ``aiic_tpu`` stays the reference; this package mirrors its
module names so each counterpart is easy to find:

- ``models``  — config presets, the weight bridge (numpy npz / seeded init)
                and the CLIP towers as plain functions on tensors.
- ``ops``     — attention helpers, host preprocessing, int8 quantization and
                the two hand-written Hopper kernels of the serving path
                (``csrc/``, built with nvcc at first use by ``ops._build``).
- ``engine``  — detector vocabulary, the classify program and the
                ``InteriorAnalyzer`` serving engine.

Nothing here imports JAX. The JAX-free ``aiic_tpu.data`` and
``aiic_tpu.utils.batching`` modules are reused as they are.
"""

__version__ = "0.1.0"
