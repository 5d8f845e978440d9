"""Evaluation metrics (paper Appendix D) with spherical quadrature weights.

The five scores the forecast engine accumulates in its rollout: fair
CRPS, ensemble-mean RMSE, spread, spread-skill ratio and the per-channel
rank histogram.
"""

from __future__ import annotations

import torch

from repro_torch.core import crps as crpslib


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
