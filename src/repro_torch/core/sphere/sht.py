"""Spherical harmonic transforms (reference path).

An FFT along longitude and a Legendre contraction along latitude.
Conventions match the JAX package: real fields (..., nlat, nlon), complex
coefficients (..., lmax, mmax) for orders m >= 0, orthonormal harmonics.
The Legendre tables travel as tensors ("buffers"); the kernel path of
the contraction lives in ``repro_torch.kernels.dispatch``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.sphere import fourier
from repro_torch.core.sphere import grids as glib
from repro_torch.core.sphere import legendre as leg


def sht_forward(x: torch.Tensor, wpct: torch.Tensor) -> torch.Tensor:
    """Forward SHT. x: (..., H, W) real -> (..., L, M) complex64.

    The contraction is fp32 whatever the table's dtype (a bf16 table, as
    the bf16 policy rounds it, is widened exactly)."""
    m = wpct.shape[2]
    w = x.shape[-1]
    wpct = wpct.float()
    xf = fourier.rfft(x.float())[..., :m] * (2.0 * math.pi / w)
    re = torch.einsum("...hm,hlm->...lm", xf.real, wpct)
    im = torch.einsum("...hm,hlm->...lm", xf.imag, wpct)
    return torch.complex(re, im)


def pad_orders(spec: torch.Tensor, nlon: int) -> torch.Tensor:
    """Zero-pad (..., H, M) Fourier orders up to the nlon//2+1 of irfft."""
    pad = nlon // 2 + 1 - spec.shape[-1]
    if pad < 0:
        raise ValueError(f"mmax={spec.shape[-1]} too large for nlon={nlon}")
    if pad:
        spec = torch.nn.functional.pad(spec, (0, pad))
    return spec


def sht_inverse(c: torch.Tensor, pct: torch.Tensor, nlon: int) -> torch.Tensor:
    """Inverse SHT. c: (..., L, M) complex -> (..., H, nlon) real, fp32
    whatever the table's dtype."""
    pct = pct.float()
    sr = torch.einsum("...lm,hlm->...hm", c.real.float(), pct)
    si = torch.einsum("...lm,hlm->...hm", c.imag.float(), pct)
    spec = pad_orders(torch.complex(sr, si), nlon)
    # irfft contributes 1/nlon and the Hermitian double-count of m>0 modes.
    return fourier.irfft(spec, nlon) * nlon


def order_extents(table: np.ndarray) -> np.ndarray:
    """Where each order of a (K, N, M) table holds its nonzeros.

    Returns (2, 2, M) int32: ``[0, :, m]`` is the half-open range
    ``[k_lo, k_hi)`` of the rows k and ``[1, :, m]`` the range
    ``[n_lo, n_hi)`` of the columns n with a nonzero ``table[k, n, m]``;
    an order with no nonzero gets ``(0, 0)`` for both.  Read from the
    data, not from the m > l triangle, so any table is covered.  The
    extents of ``table.transpose(1, 0, 2)`` are these flipped on axis 0.
    """
    nz = np.asarray(table) != 0
    ext = np.zeros((2, 2, nz.shape[2]), np.int32)
    for row, live in enumerate((nz.any(axis=1), nz.any(axis=0))):
        has = live.any(axis=0)                         # (M,)
        lo = live.argmax(axis=0)
        hi = live.shape[0] - live[::-1].argmax(axis=0)
        ext[row, 0] = np.where(has, lo, 0)
        ext[row, 1] = np.where(has, hi, 0)
    return ext


@dataclasses.dataclass(frozen=True)
class SHT:
    """Precomputed SHT for one grid; thin wrapper around the functions."""

    grid: glib.SphereGrid
    lmax: int
    mmax: int

    @classmethod
    def create(cls, grid: glib.SphereGrid, lmax: int | None = None,
               mmax: int | None = None) -> "SHT":
        """The SHT of ``grid``; lmax defaults to nlat, mmax to min(lmax, nlon//2+1)."""
        lmax = int(lmax if lmax is not None else grid.nlat)
        mmax = int(mmax if mmax is not None else min(lmax, grid.nlon // 2 + 1))
        return cls(grid=grid, lmax=lmax, mmax=mmax)

    def tables(self) -> tuple[np.ndarray, np.ndarray]:
        """(wpct, pct) as float64 numpy, each (H, L, M)."""
        pbar = leg.cached_legendre_table(self.lmax, self.mmax, self.grid.colat)
        wpct = pbar * self.grid.quad_weights[:, None, None]
        return wpct, pbar

    def buffers(self, device: torch.device | str = "cpu"
                ) -> dict[str, torch.Tensor]:
        """Legendre tables as float32 tensors (cast from float64 here),
        each with its per-order extents (``order_extents`` of the cast
        table, (H, L, M) orientation) for the kernel path."""
        wpct, pbar = (t.astype(np.float32) for t in self.tables())
        return {
            "wpct": torch.from_numpy(wpct).to(device),
            "pct": torch.from_numpy(pbar).to(device),
            "wpct_ext": torch.from_numpy(order_extents(wpct)).to(device),
            "pct_ext": torch.from_numpy(order_extents(pbar)).to(device),
        }

    def buffer_specs(self) -> dict[str, torch.Tensor]:
        """``buffers``' keys, shapes and dtypes as storage-free tensors on
        the ``meta`` device (the JAX ``ShapeDtypeStruct``s, plus the
        extents)."""
        shape = (self.grid.nlat, self.lmax, self.mmax)
        table = torch.empty(shape, dtype=torch.float32, device="meta")
        ext = torch.empty((2, 2, self.mmax), dtype=torch.int32,
                          device="meta")
        return {"wpct": table, "pct": table.clone(), "wpct_ext": ext,
                "pct_ext": ext.clone()}

    def forward(self, x: torch.Tensor, buffers: dict) -> torch.Tensor:
        """``sht_forward`` with this grid's tables."""
        return sht_forward(x, buffers["wpct"])

    def inverse(self, c: torch.Tensor, buffers: dict) -> torch.Tensor:
        """``sht_inverse`` with this grid's tables."""
        return sht_inverse(c, buffers["pct"], self.grid.nlon)


def resample(x: torch.Tensor, sht_in: SHT, sht_out: SHT,
             buffers_in: dict | None = None,
             buffers_out: dict | None = None) -> torch.Tensor:
    """Alias-free spectral resampling between grids (paper B.6, SHT
    variant): forward on ``sht_in``'s grid, keep the common degrees and
    orders, zero-pad to ``sht_out``'s and invert there.  The tables are
    built on ``x``'s device when not given."""
    bi = buffers_in if buffers_in is not None else sht_in.buffers(x.device)
    bo = (buffers_out if buffers_out is not None
          else sht_out.buffers(x.device))
    c = sht_in.forward(x, bi)
    l = min(sht_in.lmax, sht_out.lmax)
    m = min(sht_in.mmax, sht_out.mmax)
    c = torch.nn.functional.pad(c[..., :l, :m],
                                (0, sht_out.mmax - m, 0, sht_out.lmax - l))
    return sht_out.inverse(c, bo)


def spectrum(c: torch.Tensor) -> torch.Tensor:
    """Angular power spectral density: sum_m |c_l^m|^2 with the Hermitian
    double count of m>0 orders.  c: (..., L, M) -> (..., L)."""
    p = c.abs() ** 2
    mult = torch.full((p.shape[-1],), 2.0, dtype=p.dtype, device=p.device)
    mult[0] = 1.0
    return torch.einsum("...lm,m->...l", p, mult)


def mode_mask(lmax: int, mmax: int) -> np.ndarray:
    """(L, M) boolean mask of valid (m <= l) coefficient slots."""
    l = np.arange(lmax)[:, None]
    m = np.arange(mmax)[None, :]
    return m <= l
