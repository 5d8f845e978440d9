"""FCN3 spherical neural-operator processor blocks (paper C.5, Fig. 10).

A spherical ConvNeXt block: a (local DISCO or global spectral) spherical
convolution over the concatenated [latent, conditioning] state, a GELU,
a pointwise two-layer MLP, LayerScale and a residual connection; no
LayerNorm (paper C.5).  GELU is the tanh approximation, as
``jax.nn.gelu``'s default in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.sphere import disco as discolib
from repro_torch.core.sphere import spectral_conv as speclib
from repro_torch.kernels.config import KernelConfig


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, the default of ``jax.nn.gelu``."""
    return F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    """Pointwise MLP over the channel dim: ``w1`` (H, C_in), ``b1``,
    ``w2`` (C_out, H), ``b2``."""

    def __init__(self, c_in: int, c_hidden: int, c_out: int, device=None):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, device=device),
                                requires_grad=False)

        self.w1, self.b1 = p(c_hidden, c_in), p(c_hidden)
        self.w2, self.b2 = p(c_out, c_hidden), p(c_out)

    @torch.no_grad()
    def reset(self, generator: torch.Generator) -> None:
        """Draw fresh weights from ``generator`` (He-scaled, zero bias)."""
        c_hidden, c_in = self.w1.shape
        self.w1.copy_(discolib.randn_like_param(self.w1, generator)
                      * float(np.sqrt(2.0 / c_in)))
        self.w2.copy_(discolib.randn_like_param(self.w2, generator)
                      * float(np.sqrt(2.0 / c_hidden)))
        self.b1.zero_()
        self.b2.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., C, H, W) -> (..., C_out, H, W), in fp32 (bf16 weights
        of the bf16 policy are widened, as JAX promotes them)."""
        h = torch.einsum("oc,...chw->...ohw", self.w1.float(), x)
        h = gelu(h + self.b1[:, None, None])
        y = torch.einsum("oc,...chw->...ohw", self.w2.float(), h)
        return y + self.b2[:, None, None]


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Static description of one processor block."""

    kind: str              # "local" | "global"
    c_latent: int
    c_cond: int
    mlp_hidden: int
    n_basis: int = 7       # local blocks
    lmax: int = 0          # global blocks
    layer_scale_init: float = 1e-3


class Block(nn.Module):
    """One processor block: ``conv``, ``mlp`` and ``layer_scale``."""

    def __init__(self, spec: BlockSpec, device=None):
        super().__init__()
        self.spec = spec
        c_in = spec.c_latent + spec.c_cond
        if spec.kind == "local":
            # gain 2: the conv feeds a GELU (paper C.6).
            self.conv = discolib.DiscoConv(spec.c_latent, c_in, spec.n_basis,
                                           groups=1, gain=2.0, device=device)
        elif spec.kind == "global":
            self.conv = speclib.SpectralFilter(spec.c_latent, c_in, spec.lmax,
                                               device=device)
        else:
            raise ValueError(spec.kind)
        self.mlp = MLP(spec.c_latent, spec.mlp_hidden, spec.c_latent,
                       device=device)
        self.layer_scale = nn.Parameter(
            torch.full((spec.c_latent,), spec.layer_scale_init,
                       device=device), requires_grad=False)

    @torch.no_grad()
    def reset(self, generator: torch.Generator) -> None:
        """Draw fresh weights for every sub-module from ``generator``."""
        self.conv.reset(generator)
        self.mlp.reset(generator)
        self.layer_scale.fill_(self.spec.layer_scale_init)

    def forward(self, x: torch.Tensor, cond: torch.Tensor, buffers: dict,
                kernels: KernelConfig | None = None) -> torch.Tensor:
        """x: (..., C_latent, H, W); cond: (..., C_cond, H, W); buffers:
        latent DISCO buffers (local) or ``SHT.buffers`` (global)."""
        cond = cond.expand(x.shape[:-3] + cond.shape[-3:])
        h = torch.cat([x, cond], dim=-3)
        if self.spec.kind == "local":
            h = self.conv(h, buffers, stride=1, kernels=kernels)
        else:
            h = self.conv(h, buffers, nlon=x.shape[-1], kernels=kernels)
        return self.mix(x, h)

    def mix(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """The block after its convolution: GELU, the MLP, LayerScale and
        the residual, from the conv's output ``h`` (pointwise)."""
        h = gelu(h)
        h = self.mlp(h)
        return x + self.layer_scale[:, None, None] * h


def softclamp(u: torch.Tensor) -> torch.Tensor:
    """Smooth positive clamp for water channels, paper eq. (29)."""
    return torch.where(u <= 0.0, torch.zeros_like(u),
                       torch.where(u <= 0.5, u * u, u - 0.25))
