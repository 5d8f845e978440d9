"""Fully normalized associated Legendre functions (paper eq. 17).

Computes Pbar_l^m(cos theta) = c_l^m * (-1)^m * P_l^m(cos theta) such that the
spherical harmonics Y_l^m = Pbar_l^m(cos theta) e^{i m phi} are orthonormal
w.r.t. the L2(S^2) inner product, eq. (18).

The tables are computed once per grid in float64 with the standard stable
three-term recurrences (no factorials; safe up to very high degree).
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch import telemetry


def legendre_table(lmax: int, mmax: int, colat: np.ndarray) -> np.ndarray:
    """Pbar table of shape (nlat, lmax, mmax): Pbar[h, l, m] = Pbar_l^m(cos theta_h).

    Entries with m > l are zero.

    Args:
      lmax: number of degrees (l = 0 .. lmax-1).
      mmax: number of orders (m = 0 .. mmax-1), mmax <= lmax.
      colat: (nlat,) colatitudes.
    """
    if mmax > lmax:
        raise ValueError("mmax must be <= lmax")
    nlat = colat.shape[0]
    ct = np.cos(colat).astype(np.float64)
    st = np.sin(colat).astype(np.float64)

    out = np.zeros((nlat, lmax, mmax), dtype=np.float64)

    # Sectoral seeds: Pbar_m^m.
    # Pbar_0^0 = sqrt(1/(4 pi))
    pmm = np.full((nlat,), np.sqrt(1.0 / (4.0 * np.pi)), dtype=np.float64)
    for m in range(mmax):
        if m > 0:
            # Pbar_m^m = -sqrt((2m+1)/(2m)) * sin(theta) * Pbar_{m-1}^{m-1}
            # (Condon-Shortley phase folded in; consistent forward/inverse.)
            pmm = -np.sqrt((2.0 * m + 1.0) / (2.0 * m)) * st * pmm
        if m < lmax:
            out[:, m, m] = pmm
        # Pbar_{m+1}^m = sqrt(2m+3) * cos(theta) * Pbar_m^m
        if m + 1 < lmax:
            out[:, m + 1, m] = np.sqrt(2.0 * m + 3.0) * ct * pmm
        # Upward recurrence in l:
        # Pbar_l^m = a_l^m cos(theta) Pbar_{l-1}^m + b_l^m Pbar_{l-2}^m
        for l in range(m + 2, lmax):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = -np.sqrt(
                ((2.0 * l + 1.0) * (l - 1.0 - m) * (l - 1.0 + m))
                / ((2.0 * l - 3.0) * (l * l - m * m))
            )
            out[:, l, m] = a * ct * out[:, l - 1, m] + b * out[:, l - 2, m]
    return out


@functools.lru_cache(maxsize=32)
def _cached_table(lmax: int, mmax: int, colat_key: bytes, nlat: int) -> np.ndarray:
    colat = np.frombuffer(colat_key, dtype=np.float64)
    assert colat.shape[0] == nlat
    with telemetry.setup_span("plans.build", kind="legendre",
                              key=f"{nlat} rows, lmax {lmax}, mmax {mmax}"):
        return legendre_table(lmax, mmax, colat)


# Tables installed from a warm-start bundle (repro_torch.serving.bundle):
# keyed like _cached_table and consulted before it, so a replica skips the
# float64 recurrences.  An installed table is what legendre_table computes
# for its key: install_legendre_table seeds the cache, it approximates
# nothing.
_TABLE_OVERRIDES: dict[tuple, np.ndarray] = {}


def table_key(lmax: int, mmax: int, colat: np.ndarray) -> tuple:
    """Cache key identifying one Legendre table: (lmax, mmax, colat)."""
    colat = np.ascontiguousarray(colat, np.float64)
    return (int(lmax), int(mmax), colat.tobytes(), colat.shape[0])


def install_legendre_table(lmax: int, mmax: int, colat: np.ndarray,
                           table: np.ndarray) -> None:
    """Seed the table cache with a precomputed table (bundle warm start).

    ``table`` must be the (nlat, lmax, mmax) float64 array
    ``legendre_table`` computes for these arguments (the JAX package's
    ``install_legendre_table`` takes the same); the shape is checked here,
    the values are the caller's contract.
    """
    expect = (colat.shape[0], lmax, mmax)
    if tuple(table.shape) != expect:
        raise ValueError(f"legendre table shape {table.shape} does not "
                         f"match key (expected {expect})")
    _TABLE_OVERRIDES[table_key(lmax, mmax, colat)] = np.ascontiguousarray(
        table, np.float64)


def is_installed(key: tuple) -> bool:
    """Whether a table for ``key`` was installed by
    ``install_legendre_table``."""
    return key in _TABLE_OVERRIDES


def cached_legendre_table(lmax: int, mmax: int, colat: np.ndarray) -> np.ndarray:
    """``legendre_table``, cached by (lmax, mmax, colat); an installed
    table is returned without computing."""
    key = table_key(lmax, mmax, colat)
    hit = _TABLE_OVERRIDES.get(key)
    if hit is not None:
        return hit
    return _cached_table(*key)
