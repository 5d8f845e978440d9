"""Global spherical convolutions via the convolution theorem (paper B.4).

Complex per-degree channel-mixing weights (the SFNO parameterization of
FCN3's two global blocks; the JAX package's ``depthwise`` variant is not
used by FCN3 and not ported).  The SHTs go through the Legendre kernel under
``KernelConfig(sht="kernel")``; the channel mixing ``oil,...ilm->...olm``
is one large complex64 product left to ``torch.einsum``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core.sphere import sht as shtlib
from repro_torch.core.sphere.disco import randn_like_param
from repro_torch.kernels import dispatch
from repro_torch.kernels.config import KernelConfig


class SpectralFilter(nn.Module):
    """Complex weights ``w_re``/``w_im``, each (C_out, C_in, L)."""

    def __init__(self, c_out: int, c_in: int, lmax: int, device=None):
        super().__init__()
        shape = (c_out, c_in, lmax)
        self.w_re = nn.Parameter(torch.zeros(shape, device=device),
                                 requires_grad=False)
        self.w_im = nn.Parameter(torch.zeros(shape, device=device),
                                 requires_grad=False)

    @torch.no_grad()
    def reset(self, generator: torch.Generator) -> None:
        """He-style init scaled so output variance matches input (C.6)."""
        scale = float(np.sqrt(1.0 / max(self.w_re.shape[1], 1)))
        self.w_re.copy_(scale * randn_like_param(self.w_re, generator))
        self.w_im.copy_(scale * randn_like_param(self.w_im, generator))

    def forward(self, x: torch.Tensor, sht_buffers: dict, nlon: int,
                kernels: KernelConfig | None = None) -> torch.Tensor:
        """x: (..., C, H, W) -> (..., C_out, H, W) through the spectral
        domain; ``sht_buffers`` holds the (H, L, M) ``wpct``/``pct`` and,
        for the kernel path, their extents ``wpct_ext``/``pct_ext``."""
        kernel = (kernels or KernelConfig()).sht == "kernel"
        wpct, pct = sht_buffers["wpct"], sht_buffers["pct"]
        if kernel:
            c = dispatch.sht_forward(x, wpct, sht_buffers["wpct_ext"])
        else:
            c = shtlib.sht_forward(x, wpct)                # (..., C, L, M)
        w = torch.complex(self.w_re.float(), self.w_im.float())
        y = torch.einsum("oil,...ilm->...olm", w, c)
        if kernel:
            return dispatch.sht_inverse(y, pct, nlon, sht_buffers["pct_ext"])
        return shtlib.sht_inverse(y, pct, nlon)
