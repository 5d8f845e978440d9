"""Grids and quadrature rules on the sphere (paper Appendix B.1).

Two tensor-product grid families are supported:

* ``equiangular`` — equally spaced colatitudes/longitudes, eq. (10), with
  trapezoidal quadrature weights, eq. (11).  This is the native ERA5
  721x1440 lat/lon grid (includes both poles when ``nlat`` is odd).
* ``gauss`` (Gaussian / Gauss-Legendre) — colatitudes at Legendre roots,
  eq. (12), with Gauss-Legendre weights; exact for polynomial integrands in
  cos(theta) up to degree 2*nlat - 1.

All tables are precomputed in float64 NumPy; torch tensors are produced lazily.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

GRID_KINDS = ("equiangular", "gauss")


@dataclasses.dataclass(frozen=True)
class SphereGrid:
    """A tensor-product spherical grid with a quadrature rule.

    Attributes:
      nlat: number of latitude rings.
      nlon: number of longitude points per ring.
      kind: "equiangular" or "gauss".
      colat: (nlat,) colatitudes theta in [0, pi], strictly increasing.
      lons: (nlon,) longitudes phi in [0, 2*pi).
      quad_weights: (nlat,) latitudinal quadrature weights w_h such that
        integral f dmu ~= sum_h sum_w w_h * (2*pi/nlon) * f(theta_h, phi_w).
        Includes the sin(theta) Jacobian. sum(w_h) * 2*pi == 4*pi (approx).
    """

    nlat: int
    nlon: int
    kind: str
    colat: np.ndarray
    lons: np.ndarray
    quad_weights: np.ndarray

    @property
    def dphi(self) -> float:
        """Longitude spacing in radians."""
        return 2.0 * np.pi / self.nlon

    @property
    def cell_area(self) -> np.ndarray:
        """(nlat,) area weight per grid point on that ring (w_h * dphi)."""
        return self.quad_weights * self.dphi

    @property
    def shape(self) -> tuple[int, int]:
        """(nlat, nlon)."""
        return (self.nlat, self.nlon)

    def area_weights_2d(self) -> np.ndarray:
        """(nlat, nlon) normalized area weights summing to one."""
        w = np.broadcast_to(self.cell_area[:, None], (self.nlat, self.nlon))
        return (w / w.sum()).astype(np.float64)


def _equiangular_colat(nlat: int) -> np.ndarray:
    # Paper eq. (10a): theta_i = pi * i / nlat, i = 0..nlat-1 describes a grid
    # that includes the north pole but not the south pole. ERA5's 721-point
    # grid however includes both poles (theta = pi*i/(nlat-1)). We follow the
    # ERA5 convention (poles included) since that is what FCN3 consumes.
    return np.linspace(0.0, np.pi, nlat)


def _trapezoidal_weights(colat: np.ndarray) -> np.ndarray:
    """Trapezoidal quadrature in theta with the sin(theta) Jacobian.

    For f integrated as int_0^pi f(theta) sin(theta) dtheta with samples at
    ``colat``: piecewise-linear (trapezoid) weights times sin(theta_h).
    Endpoints (poles) get half intervals; sin there is 0 which would discard
    pole information entirely, so we use the standard "area of the latitude
    band" weights instead: w_h = cos(theta_{h-1/2}) - cos(theta_{h+1/2}),
    with half-bands at the poles. These are positive, sum to exactly 2 and
    reduce to sin(theta)*dtheta in the interior.
    """
    edges = np.concatenate(
        [[0.0], 0.5 * (colat[1:] + colat[:-1]), [np.pi]]
    )
    w = np.cos(edges[:-1]) - np.cos(edges[1:])
    return w


def _legendre_gauss_nodes(nlat: int) -> tuple[np.ndarray, np.ndarray]:
    x, w = np.polynomial.legendre.leggauss(nlat)
    # x in (-1, 1) ascending; colat = arccos(x) is descending -> flip.
    colat = np.arccos(x)[::-1].copy()
    w = w[::-1].copy()
    return colat, w


@functools.lru_cache(maxsize=64)
def make_grid(nlat: int, nlon: int, kind: str = "equiangular") -> SphereGrid:
    """The (cached) grid of ``kind`` with nlat x nlon points."""
    if kind not in GRID_KINDS:
        raise ValueError(f"unknown grid kind {kind!r}; expected one of {GRID_KINDS}")
    if kind == "equiangular":
        colat = _equiangular_colat(nlat)
        qw = _trapezoidal_weights(colat)
    else:
        colat, qw = _legendre_gauss_nodes(nlat)
    lons = np.arange(nlon) * (2.0 * np.pi / nlon)
    return SphereGrid(
        nlat=nlat, nlon=nlon, kind=kind,
        colat=colat, lons=lons, quad_weights=qw,
    )


def quad_integrate(grid: SphereGrid, values: np.ndarray) -> np.ndarray:
    """Numerically integrate ``values`` (..., nlat, nlon) over the sphere."""
    w = grid.cell_area
    return np.einsum("...hw,h->...", values, w)
