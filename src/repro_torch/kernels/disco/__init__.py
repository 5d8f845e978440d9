"""Banded DISCO contraction: CUDA kernel wrapper and plain version."""
