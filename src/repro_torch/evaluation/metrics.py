"""Evaluation metrics (paper Appendix D) and spectral diagnostics (F.7).

All spatial reductions use the spherical quadrature weights of the grid,
eq. (30): metrics are computed per channel and averaged over the sphere.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import crps as crpslib
from repro_torch.core.sphere import sht as shtlib


def _spatial_mean(x: torch.Tensor, area_weights: torch.Tensor
                  ) -> torch.Tensor:
    """x: (..., H, W) -> (...) weighted spatial mean.

    The denominator is the same contraction on a field of ones (not a
    plain sum), so its rounding matches the numerator's and a constant
    field's mean is exact.
    """
    w = area_weights.to(x.dtype)
    return (torch.einsum("...hw,hw->...", x, w)
            / torch.einsum("...hw,hw->...", torch.ones_like(w), w))


def rmse(pred: torch.Tensor, target: torch.Tensor,
         area_weights: torch.Tensor) -> torch.Tensor:
    """Paper eq. (31). pred/target: (..., H, W)."""
    return torch.sqrt(_spatial_mean((pred - target) ** 2, area_weights))


def mae(pred: torch.Tensor, target: torch.Tensor,
        area_weights: torch.Tensor) -> torch.Tensor:
    """Paper eq. (32)."""
    return _spatial_mean((pred - target).abs(), area_weights)


def acc(pred: torch.Tensor, target: torch.Tensor, climatology: torch.Tensor,
        area_weights: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Anomaly correlation coefficient, eq. (33)."""
    pa = pred - climatology
    ta = target - climatology
    num = _spatial_mean(pa * ta, area_weights)
    den = torch.sqrt(_spatial_mean(pa ** 2, area_weights)
                     * _spatial_mean(ta ** 2, area_weights))
    return num / (den + eps)


def ensemble_mean(ens: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Mean over the ensemble dimension ``dim``."""
    return ens.mean(dim=dim)


def ensemble_skill(ens: torch.Tensor, target: torch.Tensor,
                   area_weights: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Ensemble-mean RMSE, eq. (35)."""
    return rmse(ensemble_mean(ens, dim), target, area_weights)


def ensemble_spread(ens: torch.Tensor, area_weights: torch.Tensor,
                    dim: int = 0) -> torch.Tensor:
    """Eq. (38): sqrt of the spatially averaged ensemble variance
    (unbiased, ``correction=1`` as ``jnp.var(ddof=1)``)."""
    var = torch.var(ens, dim=dim, correction=1)
    return torch.sqrt(_spatial_mean(var, area_weights))


def spread_skill_ratio(ens: torch.Tensor, target: torch.Tensor,
                       area_weights: torch.Tensor, dim: int = 0
                       ) -> torch.Tensor:
    """Eq. (39), with the sqrt((E+1)/E) finite-ensemble correction."""
    e = ens.shape[dim]
    corr = ((e + 1.0) / e) ** 0.5
    return (corr * ensemble_spread(ens, area_weights, dim)
            / ensemble_skill(ens, target, area_weights, dim))


def crps(ens: torch.Tensor, target: torch.Tensor,
         area_weights: torch.Tensor, dim: int = 0, fair: bool = True
         ) -> torch.Tensor:
    """Spatially averaged (fair, per WB2) ensemble CRPS."""
    pt = crpslib.crps_ensemble(ens, target, dim=dim, fair=fair)
    return _spatial_mean(pt, area_weights)


def ring_weights(area_weights: torch.Tensor) -> torch.Tensor:
    """(H,) per-point weight on each latitude ring (area weights of
    tensor-product grids do not vary along longitude)."""
    return area_weights[..., :, 0].float()


def ring_contract(counts: torch.Tensor, area_weights: torch.Tensor
                  ) -> torch.Tensor:
    """(..., H, R) per-ring integer bin counts -> (..., R) weighted
    frequencies: the one float contraction of the rank histogram."""
    return torch.einsum("...hr,h->...r", counts.float(),
                        ring_weights(area_weights))


def rank_histogram_per_channel(ens: torch.Tensor, target: torch.Tensor,
                               area_weights: torch.Tensor, dim: int = 0
                               ) -> torch.Tensor:
    """Per-channel area-weighted rank frequencies, (..., E+1).

    Reference for the engine's ``in_scan_rank_histogram``: ranks are
    comparison counts, one-hot binned per latitude ring, then contracted
    with the ring weights.
    """
    e = ens.shape[dim]
    rank = (ens < target.unsqueeze(dim)).sum(dim=dim)       # (..., H, W)
    onehot = torch.nn.functional.one_hot(rank, e + 1)       # (..., H, W, E+1)
    return ring_contract(onehot.sum(dim=-2), area_weights)


def rank_histogram(ens: torch.Tensor, target: torch.Tensor,
                   area_weights: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Area-weighted frequencies of the observation's rank within the
    ensemble (F.3), (E+1,), averaged over any remaining leading dims; a
    calibrated ensemble is flat at 1/(E+1) (Hamill 2001)."""
    e = ens.shape[dim]
    rank = (ens < target.unsqueeze(dim)).sum(dim=dim)       # (..., H, W)
    onehot = torch.nn.functional.one_hot(rank, e + 1).float()
    hist = torch.einsum("...hwr,hw->...r", onehot, area_weights.float())
    return hist.reshape((-1, e + 1)).mean(dim=0)


def angular_psd(x: torch.Tensor, wpct: torch.Tensor) -> torch.Tensor:
    """Angular power spectral density, eq. (53). x: (..., H, W) -> (..., L)."""
    return shtlib.spectrum(shtlib.sht_forward(x, wpct))


def ensemble_spectrum(ens: torch.Tensor, wpct: torch.Tensor, dim: int = 0
                      ) -> torch.Tensor:
    """Member-mean per-degree energy spectrum (paper Fig. 5 diagnostic):
    (E, ..., H, W) -> (..., L)."""
    return angular_psd(ens, wpct).mean(dim=dim)


def zonal_psd(x: torch.Tensor, lat_index: int, colat: float) -> torch.Tensor:
    """Zonal PSD at one latitude ring, eq. (54).
    x: (..., H, W) -> (..., W//2+1)."""
    ring = x[..., lat_index, :]
    w = ring.shape[-1]
    f = torch.fft.rfft(ring, dim=-1) * (2.0 * math.pi / w)
    return 2.0 * math.pi * math.sin(colat) * f.abs() ** 2


def bias(ens: torch.Tensor, target: torch.Tensor, dim: int = 0
         ) -> torch.Tensor:
    """Pointwise expected error, eq. (52), averaged over the ensemble dim."""
    return ens.mean(dim=dim) - target
