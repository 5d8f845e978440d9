"""Spherical diffusion processes (paper B.7, Palmer et al. 2009).

A first-order auto-regressive Gaussian process in spherical-harmonic space,
``z_n = phi * z_{n-1} + sum_{l,m} sigma_l eta_l^m Y_l^m`` (eq. 27).  The
white draws come from a ``torch.Generator`` passed in explicitly; JAX's
threefry streams cannot be reproduced, so tests hand in the reference's
draws instead (``step_with`` takes the draw).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.sphere import sht as shtlib

# Table 1 length scales.
FCN3_KT_SCALES = (3.08e-5, 1.23e-4, 4.93e-4, 1.97e-3,
                  7.89e-3, 3.16e-2, 1.26e-1, 5.05e-1)


def power_law_sigma_l(lmax: int, slope: float = 3.0, peak_l: int = 4,
                      band_limit: float = 0.85) -> np.ndarray:
    """(L,) per-degree std of an atmospheric power-law spectrum, band-
    limited below ``band_limit * lmax`` and normalized to unit pointwise
    variance: Var = sum_l sigma_l^2 (2l+1) / (4 pi)."""
    ell = np.arange(lmax, dtype=np.float64)
    s = (1.0 + (ell / peak_l) ** slope) ** -1.0
    s[0] = 0.0
    s[ell > band_limit * lmax] = 0.0
    var = (s * (2 * ell + 1) / (4 * np.pi)).sum()
    return np.sqrt(s / var).astype(np.float32)


def sample_spectral_coeffs(generator: torch.Generator,
                           batch_shape: tuple[int, ...],
                           sigma_l: torch.Tensor, lmax: int, mmax: int
                           ) -> torch.Tensor:
    """White orthonormal-basis SH coefficients scaled per degree.

    m = 0 coefficients are real N(0,1); m > 0 are complex with Re, Im ~
    N(0, 1/2).  ``sigma_l`` (..., L) broadcasts against
    ``batch_shape + (L, M)`` from the right.  Returns complex64, on
    ``sigma_l``'s device.
    """
    shape = tuple(batch_shape) + (lmax, mmax)
    dev = sigma_l.device
    re = torch.randn(shape, generator=generator,
                     device=generator.device).to(dev)
    im = torch.randn(shape, generator=generator,
                     device=generator.device).to(dev)
    m = torch.arange(mmax, device=dev)
    scale_m = torch.where(m == 0, 1.0, math.sqrt(0.5))
    im_mask = (m != 0).float()
    mask = torch.from_numpy(shtlib.mode_mask(lmax, mmax)).float().to(dev)
    eta = torch.complex(re * scale_m, im * scale_m * im_mask) * mask
    return eta * sigma_l[..., :, None]


@dataclasses.dataclass(frozen=True)
class SphericalDiffusion:
    """A bank of spherical AR(1) diffusion processes sharing one SHT."""

    sht: shtlib.SHT
    k_t: tuple[float, ...] = FCN3_KT_SCALES
    lam: float = 1.0
    sigma: float = 1.0

    @property
    def n_proc(self) -> int:
        """Number of diffusion processes."""
        return len(self.k_t)

    @property
    def phi(self) -> float:
        """Per-step AR(1) decay factor exp(-lam)."""
        return float(np.exp(-self.lam))

    def sigma_l(self) -> np.ndarray:
        """(n_proc, L) spectral standard deviations, eq. (28b)-(28c)."""
        lmax = self.sht.lmax
        l = np.arange(lmax, dtype=np.float64)
        phi = np.exp(-self.lam)
        out = np.zeros((self.n_proc, lmax))
        for i, kt in enumerate(self.k_t):
            e = np.exp(-kt * l * (l + 1.0))
            denom = ((2.0 * l + 1.0) * e)[1:].sum()  # sum over l > 0
            f0 = self.sigma * np.sqrt(2.0 * np.pi * (1.0 - phi * phi)
                                      / max(denom, 1e-30))
            out[i] = f0 * np.sqrt(e)
        out[:, 0] = 0.0  # l = 0: no mean offset, matches sum_{l>0} in (28c)
        return out

    def buffers(self, device: torch.device | str = "cpu",
                rows: tuple[int, int] | None = None
                ) -> dict[str, torch.Tensor]:
        """``pct`` (the inverse-SHT table) and ``sigma_l``; with ``rows`` =
        (lo, hi), ``pct`` of those latitudes only, so ``to_grid`` gives
        just those rows (a rank's block in the domain decomposition)."""
        _, pbar = self.sht.tables()
        if rows is not None:
            pbar = pbar[rows[0]:rows[1]]
        return {
            "pct": torch.from_numpy(pbar.astype(np.float32)).to(device),
            "sigma_l": torch.from_numpy(
                self.sigma_l().astype(np.float32)).to(device),
        }

    def sample_coeffs(self, generator: torch.Generator,
                      batch_shape: tuple[int, ...], buffers: dict
                      ) -> torch.Tensor:
        """White coefficients for the bank, (*batch, n_proc, L, M)."""
        return sample_spectral_coeffs(
            generator, tuple(batch_shape) + (self.n_proc,),
            buffers["sigma_l"], self.sht.lmax, self.sht.mmax)

    def stationary_scale(self) -> float:
        """1/sqrt(1 - phi^2): the stationary std over the innovation std."""
        phi = np.exp(-self.lam)
        return float(1.0 / np.sqrt(max(1.0 - phi * phi, 1e-12)))

    def init_state(self, generator: torch.Generator,
                   batch_shape: tuple[int, ...], buffers: dict
                   ) -> torch.Tensor:
        """Stationary sample of coefficients z_hat: (*batch, n_proc, L, M)."""
        return (self.sample_coeffs(generator, batch_shape, buffers)
                * self.stationary_scale())

    def step_with(self, z_hat: torch.Tensor, eta: torch.Tensor
                  ) -> torch.Tensor:
        """One AR(1) update, eq. (27), with the white draw ``eta`` given."""
        return self.phi * z_hat + eta

    def to_grid(self, z_hat: torch.Tensor, buffers: dict) -> torch.Tensor:
        """Coefficients -> (*batch, n_proc, H, W) real fields."""
        return shtlib.sht_inverse(z_hat, buffers["pct"], self.sht.grid.nlon)


def _mirror_pairs(x: torch.Tensor, src: torch.Tensor, n: int, dim: int
                  ) -> torch.Tensor:
    """Gather ``src`` slices along ``dim`` and negate every odd output slot.

    The one antithetic-pairing primitive (paper E.3) shared by noise
    centering (src maps members onto their even partner) and
    initial-condition perturbations (src expands K independent draws to
    2K +/- members).
    """
    idx = torch.arange(n, device=x.device)
    sign = torch.where(idx % 2 == 0, 1.0, -1.0)
    xt = x.index_select(dim, src.to(x.device))
    shape = [1] * xt.dim()
    shape[dim] = n
    return xt * sign.reshape(shape).to(x.dtype)


def center_noise(z: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Antithetic noise centering (paper E.3): odd members = -even members."""
    n = z.shape[dim]
    return _mirror_pairs(z, (torch.arange(n) // 2) * 2, n, dim)


def antithetic_expand(p: torch.Tensor, members: int, dim: int = 0
                      ) -> torch.Tensor:
    """Expand ceil(members/2) independent draws to ``members`` +/- pairs.

    p has K = ceil(members/2) slices along ``dim``; output slot 2i is +p_i
    and slot 2i+1 is -p_i (a trailing unpaired member gets +p_K-1), so
    each pair's mean is exactly the control state.
    """
    if p.shape[dim] != (members + 1) // 2:
        raise ValueError(
            f"need {(members + 1) // 2} draws for {members} antithetic "
            f"members, got {p.shape[dim]}")
    return _mirror_pairs(p, torch.arange(members) // 2, members, dim)
