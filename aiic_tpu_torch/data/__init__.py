"""Host-side data helpers of the port: copies of the parts of ``aiic_tpu.data``
that the serving engine needs (tokenizer, category vocabulary and prompts,
CLIP normalization constants), each held to its original by a test."""
