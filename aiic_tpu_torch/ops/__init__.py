"""Compute ops of the port: attention helpers, preprocessing, int8 kernels."""
