"""Building blocks the LM zoo shares: linear, RMSNorm and embeddings.

The JAX package's layouts are kept: a linear weight is ``(d_in, d_out)``
and applies as ``x @ w``.  Initialisation draws from an explicit
``torch.Generator`` (the numbers differ from ``jax.random``'s; the
distributions are the same).  RoPE, the MLPs and the cross-entropy loss
come with the attention families (ROADMAP A13).
"""

from __future__ import annotations

import math

import torch


def init_linear(generator: torch.Generator, d_in: int, d_out: int,
                scale: float | None = None) -> torch.Tensor:
    """(d_in, d_out) normal weights scaled by ``scale`` (1/sqrt(d_in))."""
    s = float(scale if scale is not None else 1.0 / math.sqrt(d_in))
    return torch.randn((d_in, d_out), generator=generator,
                       device=generator.device) * s


def linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out) -> (..., d_out)."""
    return x @ w


def init_rmsnorm(d: int, device=None) -> torch.Tensor:
    """RMSNorm gain: ones."""
    return torch.ones((d,), device=device)


def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * g, the mean taken in float32."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * g


def init_embedding(generator: torch.Generator, vocab: int, d: int
                   ) -> torch.Tensor:
    """(vocab, d) normal table times 0.02."""
    return torch.randn((vocab, d), generator=generator,
                       device=generator.device) * 0.02


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``tokens`` (any integer shape) -> (..., d)."""
    return table[tokens]
