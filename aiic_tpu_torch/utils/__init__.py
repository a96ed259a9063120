"""Host-side helpers of the port (copies of JAX-free ``aiic_tpu.utils`` modules)."""
