"""aiic_tpu_torch — the PyTorch/CUDA port of ``aiic_tpu`` for NVIDIA Hopper.

The JAX package ``aiic_tpu`` stays the reference; this package mirrors its
module names so each counterpart is easy to find:

- ``models``  — config presets, the weight bridge (numpy npz / seeded init)
                and the CLIP towers as plain functions on tensors.
- ``ops``     — attention, MLP, int8 half-blocks and the whole training
                text block (forward and backward) with their hand-written
                Hopper kernels (``csrc/``, built with nvcc at first use by
                ``ops._build``), host preprocessing, int8 quantization.
- ``engine``  — detector vocabulary, the classify program and the
                ``InteriorAnalyzer`` serving engine.
- ``adapters`` — LoRA adapter trees, folding, the reference ``.pth`` layout.
- ``train``   — LoRA fine-tuning of the text tower (``train_lora``), its
                optimizer, state checkpoints and evaluation; ``cli`` holds
                its command line (``python -m aiic_tpu_torch.cli.train_lora``).
- ``data``, ``utils`` — the port's own copies of the JAX-free host helpers it
                needs (tokenizer, dataset and prompts, preprocessing,
                normalization constants, batch buckets), each held to its
                original by a test.

Nothing here imports JAX or any module of the ``aiic_tpu`` package.
"""

__version__ = "0.1.0"
