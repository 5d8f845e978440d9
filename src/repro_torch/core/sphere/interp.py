"""Bilinear interpolation of spherical signals (paper B.6, eqs. 25-26).

Gather indices and weights are precomputed in numpy (identical to the
JAX package); longitude is periodic and latitudes beyond the first/last
ring interpolate against the pole value, the longitudinal mean of the
nearest ring (eq. 26).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.sphere import grids as glib


@dataclasses.dataclass(frozen=True)
class BilinearResample:
    """Precomputed bilinear resampling plan between two spherical grids."""

    grid_in: glib.SphereGrid
    grid_out: glib.SphereGrid
    # latitude neighbours / weights; index -1 / nlat encode poles
    lat_idx0: np.ndarray  # (H_out,) int32 in [-1, H_in-1]
    lat_w: np.ndarray     # (H_out,) float32 weight of idx0+1 neighbour
    lon_idx0: np.ndarray  # (W_out,) int32
    lon_w: np.ndarray     # (W_out,) float32

    @classmethod
    def create(cls, grid_in: glib.SphereGrid, grid_out: glib.SphereGrid):
        """Plan the bilinear resampling from ``grid_in`` onto ``grid_out``."""
        with telemetry.setup_span(
                "plans.build", kind="resample",
                key=f"{grid_in.nlat}x{grid_in.nlon} {grid_in.kind} -> "
                    f"{grid_out.nlat}x{grid_out.nlon} {grid_out.kind}"):
            return cls._plan(grid_in, grid_out)

    @classmethod
    def _plan(cls, grid_in: glib.SphereGrid, grid_out: glib.SphereGrid):
        ti, to = grid_in.colat, grid_out.colat
        # latitude: find interval; allow virtual pole rows at theta=0, pi.
        idx0 = np.searchsorted(ti, to, side="right") - 1  # in [-1, H_in-1]
        idx0 = np.clip(idx0, -1, ti.shape[0] - 1)
        t0 = np.where(idx0 >= 0, ti[np.clip(idx0, 0, None)], 0.0)
        idx1 = idx0 + 1
        t1 = np.where(idx1 <= ti.shape[0] - 1,
                      ti[np.clip(idx1, None, ti.shape[0] - 1)], np.pi)
        denom = np.where(t1 > t0, t1 - t0, 1.0)
        w = np.clip((to - t0) / denom, 0.0, 1.0)

        po = grid_out.lons
        dphi = 2.0 * np.pi / grid_in.nlon
        j0 = np.floor(po / dphi).astype(np.int64)
        wl = (po - j0 * dphi) / dphi
        j0 = j0 % grid_in.nlon
        return cls(
            grid_in=grid_in, grid_out=grid_out,
            lat_idx0=idx0.astype(np.int32), lat_w=w.astype(np.float32),
            lon_idx0=j0.astype(np.int32), lon_w=wl.astype(np.float32),
        )

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., H_in, W_in) -> (..., H_out, W_out)."""
        return self.resample_rows(x, np.arange(self.grid_in.nlat),
                                  (0, self.grid_out.nlat))

    def input_rows(self, out_block: tuple[int, int]) -> np.ndarray:
        """The sorted input rows that output rows ``[lo, hi)`` read: their
        two latitude neighbours, a pole standing for the ring next to it
        (its value is that ring's mean)."""
        i0 = self.lat_idx0[out_block[0]:out_block[1]].astype(np.int64)
        return np.unique(np.clip(np.concatenate([i0, i0 + 1]), 0,
                                 self.grid_in.nlat - 1))

    def resample_rows(self, x: torch.Tensor, rows: np.ndarray,
                      out_block: tuple[int, int]) -> torch.Tensor:
        """Output rows ``[lo, hi)`` from the input rows ``rows`` (sorted,
        covering ``input_rows(out_block)``): x (..., len(rows), W_in) ->
        (..., hi - lo, W_out).  The same arithmetic as the whole field's,
        row for row."""
        dev = x.device
        hin = self.grid_in.nlat
        lo, hi = out_block
        pos = np.full((hin,), -1, np.int64)
        pos[rows] = np.arange(len(rows))
        if (pos[self.input_rows(out_block)] < 0).any():
            raise ValueError(f"rows miss input rows that output rows "
                             f"[{lo}, {hi}) read")
        # Longitudinal interpolation first (cheap, periodic).
        j0 = torch.from_numpy(self.lon_idx0.astype(np.int64)).to(dev)
        j1 = (j0 + 1) % self.grid_in.nlon
        wl = torch.from_numpy(self.lon_w).to(dev)
        xl = x.index_select(-1, j0) * (1.0 - wl) + x.index_select(-1, j1) * wl

        # Pole rows: longitudinal mean of the nearest ring, over W_out.
        north = x[..., max(pos[0], 0), :].mean(dim=-1, keepdim=True)
        south = x[..., max(pos[hin - 1], 0), :].mean(dim=-1, keepdim=True)
        ones = torch.ones((1, xl.shape[-1]), dtype=xl.dtype, device=dev)
        xl = torch.cat([north[..., None, :] * ones, xl,
                        south[..., None, :] * ones], dim=-2)
        # (..., len(rows) + 2, W_out); row 0 = north pole, the last south.

        # input row g sits at row 1 + pos[g]; g = -1 / hin are the poles
        ext = np.concatenate([[0], 1 + pos, [len(rows) + 1]])
        g0 = self.lat_idx0[lo:hi].astype(np.int64)
        i0 = torch.from_numpy(ext[g0 + 1]).to(dev)
        i1 = torch.from_numpy(ext[g0 + 2]).to(dev)
        wt = torch.from_numpy(self.lat_w[lo:hi]).to(dev)[:, None]
        return (xl.index_select(-2, i0) * (1.0 - wt)
                + xl.index_select(-2, i1) * wt)
