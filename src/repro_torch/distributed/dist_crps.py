"""Distributed, ensemble-parallel CRPS (paper G.2.4, Algorithm 3).

Ensemble members are independent through the whole forward pass; the
only cross-member communication of a training step is here.  One tiled
all-to-all over the ensemble group gathers the members and scatters the
(flattened) space, the CRPS kernel (``csrc/crps.cu``, forward and
backward, through ``kernels.crps.ops.crps_pointwise``) scores the
rank-local points over the whole ensemble, and a ``psum`` finishes the
quadrature sum.  On CPU tensors the kernel's wrapper runs its plain
version.

The forecast engine's scores across ranks (``EngineConfig.member_axes``)
take Algorithm 3 with ragged blocks: ``member_block`` splits E members
over R ranks (whole +/- pairs where it can), ``scatter_points`` is the
all-to-all of step 1 on uneven member counts and an uneven point split
(``row_block`` of the S points, which need not fall on latitude rows),
and ``dist_crps_channels`` is steps 2-3 keeping every dim but the
points: the per-channel weighted sums.
"""

from __future__ import annotations

import torch

import math

from repro_torch.distributed.compat import (all_to_all, all_to_all_v,
                                            axis_index, axis_size, psum,
                                            row_block)
from repro_torch.kernels.config import BlockConfig
from repro_torch.kernels.crps import ops as crps_ops


def dist_crps(ens_local: torch.Tensor, obs_local: torch.Tensor,
              weights_local: torch.Tensor, group, fair: bool = False,
              blocks: BlockConfig | None = None) -> torch.Tensor:
    """Rank-local body of the distributed nodal CRPS.

    ens_local: (Eloc, ..., S) this rank's members over the flattened
      spatial block S (S divisible by the group's size);
    obs_local: (..., S) the truth on the same block;
    weights_local: (S,) quadrature weights of the block, normalized over
      all ranks and points.
    Returns the weighted CRPS summed over the points and the ``...``
    dims, the same scalar on every rank of ``group``.  ``blocks``: the
    CRPS kernels' tile (None: the committed one).
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
    pt = crps_ops.crps_pointwise(ens, obs, fair, blocks)
    part = (pt * w.to(pt.dtype)).sum()
    # 3) the quadrature sum over the group
    return psum(part, group)


def member_block(e: int, rank: int, n: int) -> tuple[int, int]:
    """The members ``[lo, hi)`` of an ensemble of ``e`` that rank
    ``rank`` of ``n`` holds.

    Whole +/- pairs (2i, 2i+1) when there are at least as many pairs as
    ranks, split as ``row_block`` splits rows (an odd E's last pair is
    its lone member), so antithetic centering stays on one rank; else the
    members one by one as ``row_block`` splits them, and a pair straddles
    two ranks (E = 2 over 2).  Every rank holds a member: ``e >= n``.
    """
    if e < n:
        raise ValueError(f"{e} members do not cover {n} ranks")
    pairs = (e + 1) // 2
    if pairs >= n:
        lo, hi = row_block(pairs, rank, n)
        return 2 * lo, min(2 * hi, e)
    return row_block(e, rank, n)


def scatter_points(ens_local: torch.Tensor, group, counts
                   ) -> tuple[torch.Tensor, tuple[int, int]]:
    """Step 1 of Algorithm 3 with ragged blocks: one ``all_to_all_v``
    takes this rank's members (E_loc, ..., S) to every member on this
    rank's block of the S points, (E, ..., S_r), the members in rank
    order.  ``counts`` are the members each rank of ``group`` holds, in
    rank order; the points split as ``row_block(S, rank, R)``.  Returns
    the gathered members and the block ``[lo, hi)``."""
    n, r = axis_size(group), axis_index(group)
    s = ens_local.shape[-1]
    if n == 1:
        return ens_local, (0, s)
    blocks = [row_block(s, q, n) for q in range(n)]
    lo, hi = blocks[r]
    mid = tuple(ens_local.shape[1:-1])
    per = math.prod(mid)
    # the blocks for each rank in rank order, each (E_loc, ..., S_q)
    send = torch.cat([ens_local[..., a:b].reshape(-1) for a, b in blocks])
    recv = all_to_all_v(send, group, 0,
                        [ens_local.shape[0] * per * (b - a)
                         for a, b in blocks],
                        [c * per * (hi - lo) for c in counts])
    return recv.reshape((sum(counts),) + mid + (hi - lo,)), (lo, hi)


def dist_crps_channels(ens: torch.Tensor, obs: torch.Tensor,
                       weights: torch.Tensor, group, fair: bool = True,
                       blocks: BlockConfig | None = None) -> torch.Tensor:
    """Steps 2-3 of Algorithm 3, per channel: the CRPS kernel scores
    this rank's points over the whole ensemble, and a ``psum`` sums the
    weighted points of every rank.

    ens: (E, ..., S_r) every member on this rank's points (from
    ``scatter_points``); obs: (..., S_r) the truth there; weights: (S_r,)
    their quadrature weights.  Returns (...), the same on every rank of
    ``group``.  ``blocks``: the CRPS kernel's tile.
    """
    pt = crps_ops.crps_pointwise(ens, obs, fair, blocks)
    return psum((pt * weights.to(pt.dtype)).sum(dim=-1), group)
