"""CLIP model: configs, weights and the towers (PyTorch port of aiic_tpu.models)."""
