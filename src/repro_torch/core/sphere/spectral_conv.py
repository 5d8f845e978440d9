"""Global spherical convolutions via the convolution theorem (paper B.4).

An axisymmetric filter acts diagonally in spherical-harmonic space,
``(u (x) k)_l^m = u_l^m * k_l^0`` (eq. 19), so the filter is parameterized
in the spectral domain, as in the JAX package.  Two modes:

* ``full`` -- complex per-degree channel-mixing weights ``w_re``/``w_im``
  (the SFNO parameterization FCN3's two global blocks use); the mixing
  ``oil,...ilm->...olm`` is one complex64 product left to ``torch.einsum``;
* ``depthwise`` -- a real per-(channel, degree) gain ``w``, the literal
  convolution theorem (strictly rotation-equivariant).

Either may truncate the spectrum to ``lmax_keep`` degrees before the
inverse transform.  The SHTs go through the Legendre kernel under
``KernelConfig(sht="kernel")``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core.sphere import sht as shtlib
from repro_torch.core.sphere.disco import randn_like_param
from repro_torch.kernels import dispatch
from repro_torch.kernels.config import KernelConfig

MODES = ("full", "depthwise")


class SpectralFilter(nn.Module):
    """``full``: complex weights ``w_re``/``w_im``, each (C_out, C_in, L);
    ``depthwise``: a real gain ``w`` (C, L), initialised to ones, which
    needs C_out == C_in."""

    def __init__(self, c_out: int, c_in: int, lmax: int, device=None,
                 mode: str = "full"):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        if mode == "depthwise":
            if c_out != c_in:
                raise ValueError("depthwise spectral filter requires "
                                 "c_out == c_in")
            self.w = nn.Parameter(torch.ones((c_in, lmax), device=device),
                                  requires_grad=False)
            return
        shape = (c_out, c_in, lmax)
        self.w_re = nn.Parameter(torch.zeros(shape, device=device),
                                 requires_grad=False)
        self.w_im = nn.Parameter(torch.zeros(shape, device=device),
                                 requires_grad=False)

    @torch.no_grad()
    def reset(self, generator: torch.Generator) -> None:
        """He-style init scaled so output variance matches input (C.6);
        a depthwise gain goes back to ones."""
        if self.mode == "depthwise":
            self.w.fill_(1.0)
            return
        scale = float(np.sqrt(1.0 / max(self.w_re.shape[1], 1)))
        self.w_re.copy_(scale * randn_like_param(self.w_re, generator))
        self.w_im.copy_(scale * randn_like_param(self.w_im, generator))

    def apply_weights(self, c: torch.Tensor, degrees=None) -> torch.Tensor:
        """The filter on coefficients c (..., C_in, L', M) -> (..., C_out,
        L', M).  ``degrees`` maps a (..., L) per-degree weight to the L'
        degrees c holds (a rank's block of them); by default c holds all
        L."""
        sel = degrees or (lambda w: w)
        if self.mode == "depthwise":
            return c * sel(self.w.float())[..., :, None]
        w = torch.complex(sel(self.w_re.float()), sel(self.w_im.float()))
        return torch.einsum("oil,...ilm->...olm", w, c)

    def forward(self, x: torch.Tensor, sht_buffers: dict, nlon: int,
                kernels: KernelConfig | None = None,
                lmax_keep: int | None = None) -> torch.Tensor:
        """x: (..., C, H, W) -> (..., C_out, H, W) through the spectral
        domain; ``sht_buffers`` holds the (H, L, M) ``wpct``/``pct`` and,
        for the kernel path, their extents ``wpct_ext``/``pct_ext``.
        ``lmax_keep`` zeroes every degree from it on (anti-aliasing)."""
        kernel = (kernels or KernelConfig()).sht == "kernel"
        wpct, pct = sht_buffers["wpct"], sht_buffers["pct"]
        if kernel:
            c = dispatch.sht_forward(x, wpct, sht_buffers["wpct_ext"],
                                     kernels)
        else:
            c = shtlib.sht_forward(x, wpct)                # (..., C, L, M)
        if lmax_keep is not None and lmax_keep < c.shape[-2]:
            c = torch.nn.functional.pad(c[..., :lmax_keep, :],
                                        (0, 0, 0, c.shape[-2] - lmax_keep))
        y = self.apply_weights(c)
        if kernel:
            return dispatch.sht_inverse(y, pct, nlon, sht_buffers["pct_ext"],
                                        kernels)
        return shtlib.sht_inverse(y, pct, nlon)
