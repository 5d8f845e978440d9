"""Mamba-2 SSD intra-chunk step: CUDA kernel wrapper and plain version."""
