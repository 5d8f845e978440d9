"""Distributed, ensemble-parallel CRPS (paper G.2.4, Algorithm 3).

Ensemble members are independent through the whole forward pass; the
only cross-member communication of a training step is here.  One tiled
all-to-all over the ensemble group gathers the members and scatters the
(flattened) space, the CRPS kernel (``csrc/crps.cu``, forward and
backward, through ``kernels.crps.ops.crps_pointwise``) scores the
rank-local points over the whole ensemble, and a ``psum`` finishes the
quadrature sum.  On CPU tensors the kernel's wrapper runs its plain
version.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.compat import (all_to_all, axis_index,
                                            axis_size, psum)
from repro_torch.kernels.crps import ops as crps_ops


def dist_crps(ens_local: torch.Tensor, obs_local: torch.Tensor,
              weights_local: torch.Tensor, group, fair: bool = False
              ) -> torch.Tensor:
    """Rank-local body of the distributed nodal CRPS.

    ens_local: (Eloc, ..., S) this rank's members over the flattened
      spatial block S (S divisible by the group's size);
    obs_local: (..., S) the truth on the same block;
    weights_local: (S,) quadrature weights of the block, normalized over
      all ranks and points.
    Returns the weighted CRPS summed over the points and the ``...``
    dims, the same scalar on every rank of ``group``.
    """
    n_e = axis_size(group)
    s = ens_local.shape[-1]
    if s % n_e:
        raise ValueError(f"dist_crps: {s} points do not split over {n_e} "
                         "ensemble ranks")
    # 1) gather the ensemble, scatter space: (Eloc, ..., S) -> (E, ..., S/R)
    ens = all_to_all(ens_local, group, ens_local.dim() - 1, 0)
    s_sub = s // n_e
    # this rank's index in the group selects its slice of obs and weights
    lo = axis_index(group) * s_sub
    obs = obs_local[..., lo:lo + s_sub]
    w = weights_local[lo:lo + s_sub]
    # 2) the CRPS kernel over the whole ensemble
    pt = crps_ops.crps_pointwise(ens, obs, fair)
    part = (pt * w.to(pt.dtype)).sum()
    # 3) the quadrature sum over the group
    return psum(part, group)
