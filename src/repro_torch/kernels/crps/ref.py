"""Plain torch versions of the fused CRPS kernel, forward and backward."""

import torch

from repro_torch.core import crps as crpslib


def crps_coeff(e: int, fair: bool) -> float:
    """The spread coefficient c: E / (E - 1) for fair CRPS, else 1."""
    return e / (e - 1.0) if fair and e > 1 else 1.0


def crps_fused_ref(ens: torch.Tensor, obs: torch.Tensor,
                   fair: bool = False) -> torch.Tensor:
    """ens: (E, N); obs: (N,) -> (N,) pointwise ensemble CRPS."""
    return crpslib.crps_ensemble(ens.float(), obs.float(), dim=0, fair=fair)


def crps_fused_bwd_ref(g: torch.Tensor, ens: torch.Tensor, obs: torch.Tensor,
                       fair: bool = False) -> torch.Tensor:
    """Gradient of ``sum(g * crps_fused_ref(ens, obs))`` w.r.t. ens.

    grad[e, n] = g[n] * (sgn(u_e - y) / E - c / E^2 * sum_i sgn(u_e - u_i))
    with sgn(0) = 0, the subgradient torch's ``abs`` takes at 0.
    g: (N,); ens: (E, N); obs: (N,) -> (E, N).
    """
    e = ens.shape[0]
    u = ens.float()
    err = torch.sign(u - obs.float()) / e
    spread = torch.sign(u[:, None] - u[None, :]).sum(dim=1)
    return g.float() * (err - crps_coeff(e, fair) / (e * e) * spread)
