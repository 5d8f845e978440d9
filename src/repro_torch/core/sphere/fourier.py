"""Longitudinal Fourier transforms (``torch.fft`` real FFTs).

The JAX package's DFT-as-GEMM ``matmul`` mode exists only to keep XLA's
SPMD partitioner from replicating FFT operands; the port has one mode.
"""

from __future__ import annotations

import torch


def rfft(x: torch.Tensor) -> torch.Tensor:
    """Real FFT along the last axis, computed in fp32 (complex64 out)."""
    if x.dtype not in (torch.float32, torch.float64):
        x = x.float()
    return torch.fft.rfft(x, dim=-1)


def irfft(c: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse real FFT along the last axis; c has n//2+1 entries."""
    return torch.fft.irfft(c, n=n, dim=-1)
