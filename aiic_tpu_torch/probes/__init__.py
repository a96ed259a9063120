"""Probes of the card, the port's twins of the TPU probes under ``tools/``."""
