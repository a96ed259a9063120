"""The benchmark of ``aiic_tpu_torch`` on an NVIDIA H100 (see ``BENCHMARK.json``
at the root and ``run.py``). It imports nothing of the JAX package."""
