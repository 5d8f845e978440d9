"""Ensemble continuously ranked probability score and the FCN3 objective
(paper D.4, E.1).

``crps_pairwise`` is the energy form, eq. (46), with the biased spread
estimate; ``crps_fair`` the unbiased-spread form, eq. (47);
``crps_sorted`` the sorted form, eq. (44).  All are pointwise in every
dimension but the ensemble one.  The composite objective, eq. (48), adds
the quadrature-weighted nodal CRPS, eq. (50), and the multiplicity-
weighted spectral CRPS, eq. (51); both score their points through the
fused CRPS kernel (``repro_torch.kernels.crps``) in both directions.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sphere import sht as shtlib


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


def crps_sorted(ens: torch.Tensor, obs: torch.Tensor, dim: int = 0
                ) -> torch.Tensor:
    """Sorted-rank CRPS, eq. (44) -- equals ``crps_pairwise``.

    Uses sum_{e<i}|u_e-u_i| = sum_e (2e+1-E) u_(e) on the sorted
    ensemble, avoiding the E^2 pairwise tensor.
    """
    e = ens.shape[dim]
    s = torch.sort(ens.movedim(dim, -1), dim=-1).values
    coeff = (2.0 * torch.arange(e, device=s.device) + 1.0 - e) / (e * e)
    spread2 = torch.einsum("...e,e->...", s, coeff.to(s.dtype))
    err = (s - obs[..., None]).abs().mean(dim=-1)
    return err - spread2


# ---------------------------------------------------------------------------
# FCN3 composite objective (E.1)
# ---------------------------------------------------------------------------

def nodal_crps_loss(ens: torch.Tensor, obs: torch.Tensor,
                    area_weights: torch.Tensor, fair: bool = False,
                    blocks=None) -> torch.Tensor:
    """Spatially averaged pointwise CRPS, eq. (50), through the kernel.

    ens: (E, ..., C, H, W); obs: (..., C, H, W); area_weights: (H, W)
    normalized quadrature weights.  Returns (..., C).  ``blocks``: the
    CRPS kernels' ``BlockConfig`` (None: the committed tile).
    """
    from repro_torch.kernels.crps import ops as crps_ops
    pt = crps_ops.crps_pointwise(ens, obs, fair, blocks)  # (..., C, H, W)
    return torch.einsum("...chw,hw->...c", pt, area_weights.to(pt.dtype))


def spectral_crps_loss(ens: torch.Tensor, obs: torch.Tensor,
                       wpct: torch.Tensor, fair: bool = False
                       ) -> torch.Tensor:
    """Spectral-domain CRPS, eq. (51), multiplicity-weighted.

    CRPS of the real and of the imaginary part of every spherical
    harmonic coefficient (one kernel call each), orders m > 0 weighted
    2x, normalized by the number of real degrees of freedom.  The forward
    SHT is the reference one (``core.sphere.sht``), as in the JAX package.
    ens: (E, ..., C, H, W); obs: (..., C, H, W).  Returns (..., C).
    """
    from repro_torch.kernels.crps import ops as crps_ops
    ce = shtlib.sht_forward(ens, wpct)        # (E, ..., C, L, M)
    co = shtlib.sht_forward(obs, wpct)
    sr = crps_ops.crps_pointwise(ce.real, co.real, fair)
    si = crps_ops.crps_pointwise(ce.imag, co.imag, fair)
    wt = torch.from_numpy(spectral_weights(*sr.shape[-2:]).astype(
        np.float32)).to(sr.device)
    return torch.einsum("...clm,lm->...c", sr + si, wt)


def spectral_weights(lmax: int, mmax: int) -> np.ndarray:
    """Eq. (51)'s weight of each (l, m) coefficient slot: the mode mask
    (m <= l) times the multiplicity (1 at m = 0, 2 above), normalized by
    the number of real degrees of freedom.  (lmax, mmax) float64."""
    mult = np.concatenate([[1.0], np.full((mmax - 1,), 2.0)])
    w = shtlib.mode_mask(lmax, mmax) * mult[None, :]
    return w / w.sum()


def fcn3_objective(ens: torch.Tensor, obs: torch.Tensor,
                   area_weights: torch.Tensor, wpct: torch.Tensor,
                   channel_weights: torch.Tensor,
                   lambda_spectral: float = 1.0, fair: bool = False
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Composite FCN3 loss, eq. (48), for one lead time.

    ens: (E, B, C, H, W); obs: (B, C, H, W); channel_weights: (C,)
    combined w_c * w_{dt,c}.  Returns (scalar loss, {"nodal", "spectral"}).
    """
    nodal = nodal_crps_loss(ens, obs, area_weights, fair)        # (B, C)
    spec = spectral_crps_loss(ens, obs, wpct, fair)              # (B, C)
    cw = (channel_weights / channel_weights.sum()).to(nodal.dtype)
    l_nodal = torch.einsum("bc,c->b", nodal, cw).mean()
    l_spec = torch.einsum("bc,c->b", spec, cw).mean()
    loss = l_nodal + lambda_spectral * l_spec
    return loss, {"nodal": l_nodal, "spectral": l_spec}
