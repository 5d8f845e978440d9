"""Ensemble continuously ranked probability score (paper D.4).

``crps_pairwise`` is the energy form, eq. (46), with the biased spread
estimate; ``crps_fair`` the unbiased-spread form, eq. (47).  Both are
pointwise in every dimension but the ensemble one.
"""

from __future__ import annotations

import torch


def _abs_err_term(ens: torch.Tensor, obs: torch.Tensor, dim: int
                  ) -> torch.Tensor:
    return (ens - obs.unsqueeze(dim)).abs().mean(dim=dim)


def _pairwise_spread(ens: torch.Tensor, dim: int) -> torch.Tensor:
    """sum_{e,i} |u_e - u_i| / E^2 along ``dim`` (E^2 energy term)."""
    a = ens.movedim(dim, 0)
    return (a[:, None] - a[None, :]).abs().mean(dim=(0, 1))


def crps_pairwise(ens: torch.Tensor, obs: torch.Tensor, dim: int = 0
                  ) -> torch.Tensor:
    """Biased ensemble CRPS, eq. (46)."""
    return _abs_err_term(ens, obs, dim) - 0.5 * _pairwise_spread(ens, dim)


def crps_fair(ens: torch.Tensor, obs: torch.Tensor, dim: int = 0
              ) -> torch.Tensor:
    """Fair (unbiased-spread) CRPS, eq. (47)."""
    e = ens.shape[dim]
    if e < 2:
        return _abs_err_term(ens, obs, dim)
    corr = e / (e - 1.0)
    return (_abs_err_term(ens, obs, dim)
            - 0.5 * corr * _pairwise_spread(ens, dim))


def crps_ensemble(ens: torch.Tensor, obs: torch.Tensor, dim: int = 0,
                  fair: bool = False) -> torch.Tensor:
    """Fair or pairwise ensemble CRPS along ``dim``."""
    return crps_fair(ens, obs, dim) if fair else crps_pairwise(ens, obs, dim)
