"""aiic_tpu_torch — the PyTorch/CUDA port of ``aiic_tpu`` for NVIDIA Hopper.

The JAX package ``aiic_tpu`` stays the reference; this package mirrors its
module names so each counterpart is easy to find:

- ``models``  — config presets, the weight bridge (numpy npz / seeded init)
                and the CLIP towers as plain functions on tensors.
- ``ops``     — attention, MLP and int8 half-blocks with their hand-written
                Hopper kernels (``csrc/``, built with nvcc at first use by
                ``ops._build``), host preprocessing, int8 quantization.
- ``engine``  — detector vocabulary, the classify program and the
                ``InteriorAnalyzer`` serving engine.
- ``data``, ``utils`` — the port's own copies of the JAX-free host helpers it
                needs (tokenizer, prompts, normalization constants, batch
                buckets), each held to its original by a test.

Nothing here imports JAX or any module of the ``aiic_tpu`` package.
"""

__version__ = "0.1.0"
