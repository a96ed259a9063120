"""Host-side data helpers of the port: copies of the parts of ``aiic_tpu.data``
that the serving engine and the trainer need (tokenizer, dataset loading,
category vocabulary and prompts, training prompts, CLIP preprocessing), each
held to its original by a test."""
