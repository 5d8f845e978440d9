"""Fused ensemble CRPS: CUDA kernel wrappers and plain versions."""
