"""Distributed DISCO convolution (paper G.2.3, Algorithm 2).

Dataflow, as in the JAX package: transpose channels <-> longitude so
each rank holds full longitude rings for a block of channels, contract
its *local input latitude rows* against the filter (partial sums for
every output latitude), reduce-scatter over the latitude group (the sum
over input rows, the output rows scattered), then transpose channels
back.  Each latitude rank's filter keeps only the taps that read its own
input rows, so no halo exchange is needed.

The rank-local contraction takes one of two layouts:

* ``local_psi_blocks`` -- the JAX package's dense masked psi
  (K, H_out, Hloc_in, W_in) with the FFT correlation: the plain version;
* ``local_band_buffers`` -- the plan's banded split with the other ranks'
  taps zeroed and ``lat_idx`` remapped to local rows, with its live taps
  read off the masked band: the band kernel (``csrc/disco_band.cu``) on
  a CUDA tensor, its wrapper's plain version on a CPU one, plus the
  near-pole wrap rows through the FFT path with the same mask.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sphere import disco as discolib
from repro_torch.core.sphere import fourier
from repro_torch.distributed.compat import all_to_all, psum_scatter
from repro_torch.kernels import dispatch
from repro_torch.kernels.config import KernelConfig


def local_psi_blocks(plan: discolib.DiscoPlan, n_lat_ranks: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Per-rank dense psi: (R, K, H_out, H_in_loc, W_in).

    Densifies the band over each rank's local input rows.  Also returns
    the local row counts (all equal; H_in must divide n_lat_ranks).
    """
    k, h_out, s, w_in = plan.psi.shape
    h_in = plan.grid_in.nlat
    assert h_in % n_lat_ranks == 0, (h_in, n_lat_ranks)
    loc = h_in // n_lat_ranks
    dense = np.zeros((k, h_out, h_in, w_in), np.float32)
    rows = plan.lat_idx  # (H_out, S)
    for h in range(h_out):
        for si in range(s):
            dense[:, h, rows[h, si], :] += plan.psi[:, h, si, :]
    blocks = dense.reshape(k, h_out, n_lat_ranks, loc, w_in)
    blocks = np.moveaxis(blocks, 2, 0)  # (R, K, H_out, loc, W)
    return blocks, np.full((n_lat_ranks,), loc, np.int32)


def local_band_buffers(plan: discolib.DiscoPlan, rank: int,
                       n_lat_ranks: int,
                       device: torch.device | str = "cpu"
                       ) -> dict[str, torch.Tensor]:
    """Latitude rank ``rank``'s banded buffers: ``DiscoPlan.
    banded_buffers``' keys over its ``H_in / n_lat_ranks`` input rows.

    The taps whose input row lies on another rank are zeroed in
    ``psi_band`` and in ``psi_wrap``; ``lat_idx`` points at local rows (a
    zeroed tap at local row 0); the live taps and their lists by input
    row are read off the masked band, so the kernel skips the other
    ranks' taps.
    """
    h_in = plan.grid_in.nlat
    assert h_in % n_lat_ranks == 0, (h_in, n_lat_ranks)
    loc = h_in // n_lat_ranks
    r0 = rank * loc
    band, wrap_rows, psi_wrap = plan.banded_split()
    mine = (plan.lat_idx >= r0) & (plan.lat_idx < r0 + loc)   # (H_out, S)
    band = band * mine[None, :, :, None]
    psi_wrap = psi_wrap * mine[wrap_rows][None, :, :, None]
    lat_idx = np.where(mine, plan.lat_idx - r0, 0).astype(np.int32)
    taps = discolib.band_live_taps(band)
    arrays = {**taps, **discolib.band_row_taps(lat_idx, taps, loc),
              "psi_band": band.astype(np.float32),
              "psi_wrap": psi_wrap.astype(np.float32),
              "wrap_rows": wrap_rows.astype(np.int64), "lat_idx": lat_idx}
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for k, a in arrays.items()}


def _dense_contract(x: torch.Tensor, psi_local: torch.Tensor, stride: int
                    ) -> torch.Tensor:
    """The JAX package's local contraction: (..., loc, W) against the
    dense psi (K, H_out, loc, W) by FFT correlation."""
    w_in = psi_local.shape[-1]
    xf = fourier.rfft(x.float())
    pf = fourier.rfft(psi_local.float())                 # (K, H_out, loc, F)
    out = fourier.irfft(torch.einsum("...sf,khsf->...khf", xf, pf.conj()),
                        w_in)
    return out[..., ::stride] if stride > 1 else out


def dist_disco_conv(x: torch.Tensor, local: dict | torch.Tensor,
                    stride: int, lat_group, lon_group,
                    kernels: KernelConfig | None = None) -> torch.Tensor:
    """Rank-local body of the distributed DISCO contraction.

    x: (..., C, Hloc_in, Wloc) this rank's input block.  ``local``: this
    latitude rank's ``local_band_buffers`` or its dense psi slab
    (K, H_out, Hloc_in, W_in) from ``local_psi_blocks``.  Returns
    (..., C, K, Hloc_out, Wloc_out), this rank's output block.  The
    band kernels launch at ``kernels``' tiles.
    """
    nd = x.dim()
    # 1) gather longitudes, scatter channels
    xt = all_to_all(x, lon_group, nd - 3, nd - 1)       # (.., Cw, loc, W)
    # 2) contract this rank's input rows -> partial sums, every H_out
    if isinstance(local, dict):
        partial = dispatch.disco_conv_banded_buffers(xt, local, stride,
                                                     kernels)
    else:
        partial = _dense_contract(xt, local, stride)   # (.., Cw, K, H, W')
    # 3) sum over the latitude ranks' rows, scatter the output rows
    out = psum_scatter(partial, lat_group, partial.dim() - 2)
    # 4) transpose channels back <-> longitudes
    return all_to_all(out, lon_group, out.dim() - 1, out.dim() - 4)
