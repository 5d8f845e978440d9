"""Building blocks the LM zoo shares: linear, RMSNorm, embeddings, RoPE
and the two MLPs.

The JAX package's layouts are kept: a linear weight is ``(d_in, d_out)``
and applies as ``x @ w``.  Initialisation draws from an explicit
``torch.Generator`` (the numbers differ from ``jax.random``'s; the
distributions are the same).  ``Params`` holds a block's named weights
as an ``nn.Module``, so the ``state_dict`` keys follow the JAX tree.
``cross_entropy_loss`` is the LM's training loss.
"""

from __future__ import annotations

import functools
import math
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import tally


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


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``tokens`` (any integer shape) -> (..., d)."""
    return table[tokens]


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """The rotary frequencies theta^(-2i/D), i < D/2, in float64."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=64)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device
                   ) -> torch.Tensor:
    # held per device: a fresh host copy at each decode layer would wait
    # for the card
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotary position embedding over the halves of the last axis (not
    interleaved pairs), the angles in float32 from absolute positions.

    x: (..., S, H, D); positions: broadcastable to (..., S).
    """
    d = x.shape[-1]
    if tally.is_fake(x):   # a dry run: nothing kept past it
        freqs = torch.as_tensor(rope_freqs(d, theta), dtype=torch.float32,
                                device=x.device)
    else:
        freqs = _rope_freqs_on(d, float(theta), x.device)
    ang = positions[..., None].float() * freqs               # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Mean next-token cross-entropy, as the JAX package's: logits (B, S,
    V), labels (B, S) int; the log-softmax in float32, labels equal to
    ``ignore_index`` left out, the mean over the valid ones (at least
    one in the denominator)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, safe[..., None])[..., 0]
    return -(ll * valid).sum() / valid.sum().clamp_min(1)


def swiglu_shapes(d: int, d_ff: int) -> dict[str, tuple[int, ...]]:
    """The SwiGLU MLP's weights."""
    return {"w_gate": (d, d_ff), "w_up": (d, d_ff), "w_down": (d_ff, d)}


def init_swiglu(generator: torch.Generator, d: int, d_ff: int) -> dict:
    """SwiGLU weights, each drawn as ``init_linear``."""
    return {name: init_linear(generator, *shape)
            for name, shape in swiglu_shapes(d, d_ff).items()}


def swiglu(p: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """w_down(silu(w_gate x) * w_up x)."""
    return linear(p["w_down"],
                  F.silu(linear(p["w_gate"], x)) * linear(p["w_up"], x))


def gelu_mlp_shapes(d: int, d_ff: int) -> dict[str, tuple[int, ...]]:
    """The GELU MLP's weights and biases."""
    return {"w_up": (d, d_ff), "b_up": (d_ff,), "w_down": (d_ff, d),
            "b_down": (d,)}


def init_gelu_mlp(generator: torch.Generator, d: int, d_ff: int) -> dict:
    """GELU MLP weights drawn as ``init_linear``, zero biases."""
    dev = generator.device
    return {"w_up": init_linear(generator, d, d_ff),
            "b_up": torch.zeros((d_ff,), device=dev),
            "w_down": init_linear(generator, d_ff, d),
            "b_down": torch.zeros((d,), device=dev)}


def gelu_mlp(p: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """w_down gelu(w_up x + b_up) + b_down, with ``jax.nn.gelu``'s default
    tanh approximation (not torch's exact default)."""
    h = F.gelu(linear(p["w_up"], x) + p["b_up"], approximate="tanh")
    return linear(p["w_down"], h) + p["b_down"]


class Params(nn.Module):
    """A block's named weights as frozen parameters, for the functional
    ``apply_*`` (``params()`` returns them by name).  Built with zeros;
    ``load`` copies values in."""

    def __init__(self, shapes: Mapping[str, tuple[int, ...]], device=None):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, device=device), requires_grad=False))

    @torch.no_grad()
    def load(self, values: Mapping[str, torch.Tensor]) -> None:
        """Copy ``values`` (one per parameter) into the parameters."""
        if sorted(values) != sorted(n for n, _ in self.named_parameters()):
            raise KeyError(f"want {sorted(self._parameters)}, got "
                           f"{sorted(values)}")
        for name, val in values.items():
            getattr(self, name).copy_(val)

    def params(self) -> dict[str, torch.Tensor]:
        """The parameters by name."""
        return dict(self.named_parameters())
