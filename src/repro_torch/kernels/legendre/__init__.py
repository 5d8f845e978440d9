"""Legendre contraction: CUDA kernel wrapper and plain version."""
