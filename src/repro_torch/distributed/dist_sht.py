"""Distributed SHT by pencil decomposition (paper G.2.2, Algorithm 1).

Rank-local bodies, as in the JAX package: each distributed transpose is
a tiled all-to-all that trades a sharded spatial axis for a sharded
channel axis, so the FFT (longitude) and the Legendre contraction
(latitude) always run on rank-local, contiguous data::

  x (B, C, Hloc, Wloc)
   --all_to_all(lon: C->Cloc, gather W)-->   (B, Cw, Hloc, W)
   --local rFFT, truncate to mmax-->         (B, Cw, Hloc, M)
   --all_to_all(lon: scatter M, C back)-->   (B, C, Hloc, Mloc)
   --all_to_all(lat: C->Ch, gather H)-->     (B, Ch, H, Mloc)
   --local Legendre contraction-->           (B, Ch, L, Mloc)
   --all_to_all(lat: scatter L, C back)-->   (B, C, Lloc, Mloc)

The Legendre step runs the port's Legendre kernel (``csrc/legendre.cu``,
through ``kernels.dispatch.legendre``) on the tables sliced to
this rank's block of orders; on CPU tensors the kernel's wrapper runs its
plain version.  The kernel takes complex64 in one launch.  Channel counts
must divide the axis sizes (the JAX package keeps channels padded to a
multiple, as the paper's ragged splits are not tracked).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.sphere import fourier
from repro_torch.core.sphere import sht as shtlib
from repro_torch.distributed.compat import all_to_all, axis_size
from repro_torch.kernels import dispatch
from repro_torch.kernels.config import KernelConfig


def order_block(mmax: int, n_lon_ranks: int, lon_rank: int
                ) -> tuple[int, int]:
    """The orders ``[m0, m1)`` longitude rank ``lon_rank`` holds."""
    if mmax % n_lon_ranks:
        raise ValueError(f"mmax={mmax} does not split over {n_lon_ranks} "
                         "longitude ranks")
    loc = mmax // n_lon_ranks
    return lon_rank * loc, (lon_rank + 1) * loc


def local_sht_buffers(sht: shtlib.SHT, m0: int, m1: int,
                      device: torch.device | str = "cpu"
                      ) -> dict[str, torch.Tensor]:
    """``sht``'s tables sliced to the orders ``[m0, m1)``, each with the
    ``order_extents`` of its slice (what the Legendre kernel checks its
    table against), computed once here: (H, L, Mloc) ``wpct``/``pct``
    float32 and (2, 2, Mloc) ``wpct_ext``/``pct_ext`` int32."""
    wpct, pct = (np.ascontiguousarray(t[:, :, m0:m1].astype(np.float32))
                 for t in sht.tables())
    return {
        "wpct": torch.from_numpy(wpct).to(device),
        "pct": torch.from_numpy(pct).to(device),
        "wpct_ext": torch.from_numpy(shtlib.order_extents(wpct)).to(device),
        "pct_ext": torch.from_numpy(shtlib.order_extents(pct)).to(device),
    }


def dist_sht_forward(x: torch.Tensor, local: dict, mmax: int,
                     lat_group, lon_group,
                     kernels: KernelConfig | None = None) -> torch.Tensor:
    """Rank-local body of the forward SHT.

    x: (..., C, Hloc, Wloc) this rank's block of the real signal;
    ``local``: ``local_sht_buffers`` of this rank's order block.  Returns
    (..., C, Lloc, Mloc) complex64, this rank's block of coefficients
    (degrees over the latitude group, orders over the longitude group).
    The Legendre kernel launches at ``kernels``' tile.
    """
    nd = x.dim()
    w_total = x.shape[-1] * axis_size(lon_group)
    # 1) gather longitudes, scatter channels (pencil 1)
    xt = all_to_all(x, lon_group, nd - 3, nd - 1)       # (.., Cw, Hloc, W)
    # 2) local FFT + mode truncation
    xf = fourier.rfft(xt.float())[..., :mmax] * (2.0 * math.pi / w_total)
    # 3) scatter orders, gather channels back
    xf = all_to_all(xf, lon_group, nd - 1, nd - 3)      # (.., C, Hloc, Mloc)
    # 4) gather latitudes, scatter channels (pencil 2)
    xf = all_to_all(xf, lat_group, nd - 3, nd - 2)      # (.., Ch, H, Mloc)
    # 5) the Legendre kernel on this rank's orders
    c = dispatch.legendre(xf, local["wpct"], local["wpct_ext"], kernels)
    # 6) scatter degrees, gather channels back
    return all_to_all(c, lat_group, nd - 2, nd - 3)     # (.., C, Lloc, Mloc)


def dist_sht_inverse(c: torch.Tensor, local: dict, nlon: int,
                     lat_group, lon_group,
                     kernels: KernelConfig | None = None) -> torch.Tensor:
    """Rank-local body of the inverse SHT.

    c: (..., C, Lloc, Mloc) complex; ``local``: ``local_sht_buffers`` of
    this rank's order block.  Returns (..., C, Hloc, Wloc) float32.  The
    Legendre kernel launches at ``kernels``' tile.
    """
    nd = c.dim()
    # 1) gather degrees, scatter channels
    ct = all_to_all(c, lat_group, nd - 3, nd - 2)       # (.., Ch, L, Mloc)
    # 2) the Legendre kernel over degrees (the transposed table)
    s = dispatch.legendre(ct, local["pct"].permute(1, 0, 2),
                          dispatch.transposed_extents(local["pct_ext"]),
                          kernels)
    # 3) scatter latitudes, gather channels
    s = all_to_all(s, lat_group, nd - 2, nd - 3)        # (.., C, Hloc, Mloc)
    # 4) gather orders, scatter channels
    s = all_to_all(s, lon_group, nd - 3, nd - 1)        # (.., Cw, Hloc, M)
    u = fourier.irfft(shtlib.pad_orders(s, nlon), nlon) * nlon
    # 5) scatter longitudes, gather channels back
    return all_to_all(u, lon_group, nd - 1, nd - 3)     # (.., C, Hloc, Wloc)
