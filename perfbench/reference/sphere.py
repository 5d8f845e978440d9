"""Plain PyTorch geometry on the sphere: grids, Legendre tables, the
spherical harmonic transforms, DISCO filters and their contraction, the
bilinear upsample and the spherical noise spectra.

A frozen, independent copy of the mathematics of FourCastNet 3 (Bonev et
al. 2025, Appendices B-C) as the port computes it.  Every table is worked
out here again, in float64 on the device, from the grid sizes alone:
nothing is read from the program.  The contractions run in float32 with
plain torch operations (FFTs and einsums); the precision of the matrix
products is whatever ``torch.backends`` says when they run, so the
control runs the same code with TF32 on.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Grids (paper B.1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Grid:
    """A tensor-product grid: colatitudes, longitudes, ring weights."""

    nlat: int
    nlon: int
    kind: str
    colat: np.ndarray
    lons: np.ndarray
    quad_weights: np.ndarray

    @property
    def cell_area(self) -> np.ndarray:
        """(nlat,) area of one point of each ring."""
        return self.quad_weights * (2.0 * np.pi / self.nlon)

    def area_weights(self) -> np.ndarray:
        """(nlat, nlon) area weights normalised to sum to one."""
        w = np.broadcast_to(self.cell_area[:, None], (self.nlat, self.nlon))
        return w / w.sum()


def make_grid(nlat: int, nlon: int, kind: str) -> Grid:
    """Equiangular grids include both poles (ERA5's 721 rows) and take
    band-area weights; Gaussian grids take Gauss-Legendre nodes."""
    if kind == "equiangular":
        colat = np.linspace(0.0, np.pi, nlat)
        edges = np.concatenate([[0.0], 0.5 * (colat[1:] + colat[:-1]),
                                [np.pi]])
        qw = np.cos(edges[:-1]) - np.cos(edges[1:])
    elif kind == "gauss":
        x, w = np.polynomial.legendre.leggauss(nlat)
        colat = np.arccos(x)[::-1].copy()
        qw = w[::-1].copy()
    else:
        raise ValueError(f"unknown grid kind {kind!r}")
    return Grid(nlat, nlon, kind, colat, np.arange(nlon) * (2 * np.pi / nlon),
                qw)


# ---------------------------------------------------------------------------
# Legendre tables and the SHT (paper B.2, eqs. 17-18)
# ---------------------------------------------------------------------------

def legendre_table(lmax: int, mmax: int, colat: np.ndarray,
                   device) -> torch.Tensor:
    """(nlat, lmax, mmax) float64 orthonormal Pbar_l^m(cos theta), zero
    for m > l, by the three-term recurrence in l for all orders at once."""
    t = torch.as_tensor(colat, dtype=torch.float64, device=device)
    ct, st = torch.cos(t), torch.sin(t)
    out = torch.zeros((t.shape[0], lmax, mmax), dtype=torch.float64,
                      device=device)
    m = torch.arange(mmax, dtype=torch.float64, device=device)
    # sectoral seeds Pbar_m^m = prod_j -sqrt((2j+1)/(2j)) sin(theta) / sqrt(4pi)
    fac = torch.ones((t.shape[0], mmax), dtype=torch.float64, device=device)
    fac[:, 1:] = -torch.sqrt((2 * m[1:] + 1) / (2 * m[1:]))[None] * st[:, None]
    pmm = torch.cumprod(fac, dim=1) * math.sqrt(1.0 / (4.0 * math.pi))
    diag = torch.arange(min(lmax, mmax), device=device)
    out[:, diag, diag] = pmm[:, :len(diag)]
    sub = torch.arange(min(lmax - 1, mmax), device=device)
    out[:, sub + 1, sub] = (torch.sqrt(2 * m[sub] + 3)[None] * ct[:, None]
                            * pmm[:, sub])
    for l in range(2, lmax):
        mm = m[:min(l - 1, mmax)]
        if mm.numel() == 0:
            continue
        a = torch.sqrt((4.0 * l * l - 1.0) / (l * l - mm * mm))
        b = -torch.sqrt((2.0 * l + 1.0) * (l - 1.0 - mm) * (l - 1.0 + mm)
                        / ((2.0 * l - 3.0) * (l * l - mm * mm)))
        k = mm.numel()
        out[:, l, :k] = (a[None] * ct[:, None] * out[:, l - 1, :k]
                         + b[None] * out[:, l - 2, :k])
    return out


@dataclasses.dataclass
class SHT:
    """The transforms of one grid: ``wpct`` (quadrature-weighted) and
    ``pct`` (H, L, M) float32, L = nlat, M = min(L, nlon // 2 + 1)."""

    grid: Grid
    wpct: torch.Tensor
    pct: torch.Tensor

    @classmethod
    def create(cls, grid: Grid, device, need=("wpct", "pct"),
               dtype=torch.float32) -> "SHT":
        """Both tables (or those ``need`` names) on ``device``, in
        ``dtype``."""
        lmax = grid.nlat
        mmax = min(lmax, grid.nlon // 2 + 1)
        p = legendre_table(lmax, mmax, grid.colat, device)
        qw = torch.as_tensor(grid.quad_weights, dtype=torch.float64,
                             device=device)
        wpct = (p * qw[:, None, None]).to(dtype) if "wpct" in need else None
        pct = p.to(dtype) if "pct" in need else None
        del p
        return cls(grid, wpct, pct)

    @property
    def lmax(self) -> int:
        """Degrees kept."""
        t = self.pct if self.pct is not None else self.wpct
        return t.shape[1]

    @property
    def mmax(self) -> int:
        """Orders kept."""
        t = self.pct if self.pct is not None else self.wpct
        return t.shape[2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(..., H, W) real -> (..., L, M) complex64."""
        w = x.shape[-1]
        xf = torch.fft.rfft(x.to(self.wpct.dtype), dim=-1)[..., :self.mmax] * (
            2.0 * math.pi / w)
        re = torch.einsum("...hm,hlm->...lm", xf.real, self.wpct)
        im = torch.einsum("...hm,hlm->...lm", xf.imag, self.wpct)
        return torch.complex(re, im)

    def inverse(self, c: torch.Tensor) -> torch.Tensor:
        """(..., L, M) complex -> (..., H, W) real."""
        nlon = self.grid.nlon
        dt = self.pct.dtype
        sr = torch.einsum("...lm,hlm->...hm", c.real.to(dt), self.pct)
        si = torch.einsum("...lm,hlm->...hm", c.imag.to(dt), self.pct)
        spec = torch.complex(sr, si)
        spec = torch.nn.functional.pad(spec, (0, nlon // 2 + 1
                                              - spec.shape[-1]))
        return torch.fft.irfft(spec, n=nlon, dim=-1) * nlon


def mode_mask(lmax: int, mmax: int) -> np.ndarray:
    """(L, M) mask of the coefficient slots with m <= l."""
    return np.arange(mmax)[None, :] <= np.arange(lmax)[:, None]


def power_spectrum(c: torch.Tensor) -> torch.Tensor:
    """(..., L, M) -> (..., L): sum over m of |c|^2, orders m > 0 twice."""
    mult = torch.full((c.shape[-1],), 2.0, dtype=c.real.dtype,
                      device=c.device)
    mult[0] = 1.0
    return torch.einsum("...lm,m->...l", c.abs() ** 2, mult)


# ---------------------------------------------------------------------------
# DISCO filters (paper B.3, eqs. 20-23)
# ---------------------------------------------------------------------------

def morlet_spec(ell_max: int = 2, m_max: int = 2) -> list[tuple[int, int, str]]:
    """The real Morlet basis without the zero sin(0, 0): 7 for (2, 2)."""
    out = []
    for l in range(ell_max):
        for m in range(m_max):
            out.append((l, m, "cos"))
            if l or m:
                out.append((l, m, "sin"))
    return out


@dataclasses.dataclass
class DiscoFilter:
    """psi (K, H_out, S, W_in) float32 on the device, lat_idx (H_out, S),
    the longitude stride W_in // W_out."""

    psi: torch.Tensor
    lat_idx: torch.Tensor
    stride: int

    @classmethod
    def create(cls, grid_in: Grid, grid_out: Grid, device,
               ell_max: int = 2, m_max: int = 2,
               cutoff_factor: float = 3.0,
               dtype=torch.float32) -> "DiscoFilter":
        """psi of the Hann-windowed Morlet basis on a geodesic disk of
        radius cutoff_factor * pi / nlat_out, times the input grid's
        point areas, each basis scaled by its mean l1 norm over rows."""
        spec = morlet_spec(ell_max, m_max)
        cutoff = cutoff_factor * np.pi / grid_out.nlat
        ti, to = grid_in.colat, grid_out.colat
        h_in, h_out = grid_in.nlat, grid_out.nlat
        lo = np.searchsorted(ti, to - cutoff, side="left")
        hi = np.searchsorted(ti, to + cutoff, side="right")
        a = max(1, int(round(h_in / h_out)))
        b = int((lo - a * np.arange(h_out)).min())
        s = int((hi - a * np.arange(h_out) - b).max())
        raw = a * np.arange(h_out)[:, None] + np.arange(s)[None, :] + b
        lat_idx = np.clip(raw, 0, h_in - 1)
        valid = (raw >= lo[:, None]) & (raw < hi[:, None])

        def f64(x):
            return torch.as_tensor(x, dtype=torch.float64, device=device)

        t_o = f64(to)[:, None, None]
        t_i = f64(ti[lat_idx])[:, :, None]
        dph = f64(grid_in.lons)[None, None, :]
        cosd = (torch.cos(t_o) * torch.cos(t_i)
                + torch.sin(t_o) * torch.sin(t_i) * torch.cos(dph))
        d = torch.arccos(torch.clamp(cosd, -1.0, 1.0)) / cutoff
        alpha = torch.atan2(torch.sin(t_i) * torch.sin(dph),
                            torch.sin(t_o) * torch.cos(t_i)
                            - torch.cos(t_o) * torch.sin(t_i) * torch.cos(dph))
        del cosd
        hann = torch.cos(0.5 * np.pi * torch.clamp(d, 0.0, 1.0)) ** 2 * (
            d <= 1.0)
        weight = (f64(grid_in.cell_area[lat_idx]) * f64(valid))[:, :, None]
        psi = torch.empty((len(spec),) + tuple(d.shape), dtype=torch.float64,
                          device=device)
        for k, (l, m, kind) in enumerate(spec):
            phase = np.pi * d * (l * torch.sin(alpha) + m * torch.cos(alpha))
            osc = torch.cos(phase) if kind == "cos" else torch.sin(phase)
            psi[k] = hann * osc * weight
        norms = psi.abs().sum(dim=(2, 3)).mean(dim=1)
        norms = torch.where(norms > 0, norms, torch.ones_like(norms))
        psi = (psi / norms[:, None, None, None]).to(dtype)
        return cls(psi, torch.as_tensor(lat_idx, dtype=torch.long,
                                        device=device),
                   grid_in.nlon // grid_out.nlon)

    def contract(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H_in, W_in) -> (N, K, H_out, W_out): out[n, k, h, w] =
        sum_{s, dw} psi[k, h, s, dw] x[n, lat_idx[h, s], (w*stride + dw)
        mod W_in], as a circular correlation by real FFTs."""
        h_out, s = self.lat_idx.shape
        w_in = x.shape[-1]
        xg = x.index_select(-2, self.lat_idx.reshape(-1)).reshape(
            x.shape[0], h_out, s, w_in)
        xf = torch.fft.rfft(xg.to(self.psi.dtype), dim=-1)
        del xg
        pf = torch.fft.rfft(self.psi, dim=-1)
        prod = torch.einsum("nhsf,khsf->nkhf", xf, pf.conj())
        del xf
        out = torch.fft.irfft(prod, n=w_in, dim=-1)
        return out[..., ::self.stride] if self.stride > 1 else out


#: bytes one chunk's largest intermediate may take
CHUNK_BYTES = 1 << 30


def disco_conv(filt: DiscoFilter, x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor, groups: int) -> torch.Tensor:
    """x (N, C_in, H, W) -> (N, C_out, H_out, W_out): the contraction
    merged with ``weight`` (C_out, C_in // groups, K) per group, plus
    ``bias``; the planes go through in chunks of at most CHUNK_BYTES of
    gathered band, each under a checkpoint when gradients are on."""
    from torch.utils.checkpoint import checkpoint
    n, c_in, h_in, w_in = x.shape
    c_out, cpg, k = weight.shape
    h_out, s = filt.lat_idx.shape
    planes = max(1, CHUNK_BYTES // (8 * h_out * s * (w_in // 2 + 1)))
    track = torch.is_grad_enabled() and (x.requires_grad
                                         or weight.requires_grad)

    def merged(xc, wc, eq):
        z = filt.contract(xc.reshape((-1,) + xc.shape[-2:]))
        return torch.einsum(eq, z.reshape(xc.shape[:-2] + z.shape[1:]), wc)

    def run(xc, wc, eq):
        if track:
            return checkpoint(merged, xc, wc, eq, use_reentrant=False)
        return merged(xc, wc, eq)

    outs = []
    if groups == 1:
        cb = min(c_in, planes)
        nb = max(1, planes // cb)
        for n0 in range(0, n, nb):
            acc = None
            for c0 in range(0, c_in, cb):
                part = run(x[n0:n0 + nb, c0:c0 + cb], weight[:, c0:c0 + cb],
                           "nikhw,oik->nohw")
                acc = part if acc is None else acc + part
            outs.append(acc)
    else:
        opg = c_out // groups
        wg = weight.reshape(groups, opg, cpg, k)
        gb = max(1, min(groups, planes // cpg))
        nb = max(1, planes // (gb * cpg))
        xg = x.reshape(n, groups, cpg, h_in, w_in)
        for n0 in range(0, n, nb):
            parts = [run(xg[n0:n0 + nb, g0:g0 + gb], wg[g0:g0 + gb],
                         "ngikhw,goik->ngohw")
                     for g0 in range(0, groups, gb)]
            y = torch.cat(parts, dim=1)
            outs.append(y.reshape(y.shape[0], c_out, h_out, y.shape[-1]))
    return torch.cat(outs) + bias[:, None, None]


# ---------------------------------------------------------------------------
# Bilinear upsample (paper B.6, eqs. 25-26)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Bilinear:
    """Bilinear interpolation from ``grid_in`` to ``grid_out``: periodic
    in longitude; beyond the outermost rings against the pole value, the
    ring's longitudinal mean."""

    i0: torch.Tensor     # (H_out,) rows into the pole-padded input
    i1: torch.Tensor
    wt: torch.Tensor     # (H_out, 1)
    j0: torch.Tensor     # (W_out,)
    j1: torch.Tensor
    wl: torch.Tensor     # (W_out,)

    @classmethod
    def create(cls, grid_in: Grid, grid_out: Grid, device) -> "Bilinear":
        """The row and column neighbours and their weights."""
        ti, to = grid_in.colat, grid_out.colat
        idx0 = np.clip(np.searchsorted(ti, to, side="right") - 1, -1,
                       len(ti) - 1)
        t0 = np.where(idx0 >= 0, ti[np.clip(idx0, 0, None)], 0.0)
        idx1 = idx0 + 1
        t1 = np.where(idx1 <= len(ti) - 1,
                      ti[np.clip(idx1, None, len(ti) - 1)], np.pi)
        w = np.clip((to - t0) / np.where(t1 > t0, t1 - t0, 1.0), 0.0, 1.0)
        dphi = 2.0 * np.pi / grid_in.nlon
        j0 = np.floor(grid_out.lons / dphi).astype(np.int64)
        wl = (grid_out.lons - j0 * dphi) / dphi
        j0 %= grid_in.nlon

        def t(a, dt=torch.long):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        return cls(t(idx0 + 1), t(idx0 + 2), t(w, torch.float64)[:, None],
                   t(j0), t((j0 + 1) % grid_in.nlon), t(wl, torch.float64))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(..., H_in, W_in) -> (..., H_out, W_out)."""
        wl, wt = self.wl.to(x.dtype), self.wt.to(x.dtype)
        xl = (x.index_select(-1, self.j0) * (1.0 - wl)
              + x.index_select(-1, self.j1) * wl)
        north = x[..., 0, :].mean(dim=-1, keepdim=True)[..., None, :]
        south = x[..., -1, :].mean(dim=-1, keepdim=True)[..., None, :]
        ones = torch.ones((1, xl.shape[-1]), dtype=xl.dtype, device=x.device)
        xl = torch.cat([north * ones, xl, south * ones], dim=-2)
        return (xl.index_select(-2, self.i0) * (1.0 - wt)
                + xl.index_select(-2, self.i1) * wt)


# ---------------------------------------------------------------------------
# Spherical noise spectra (paper B.7, eqs. 27-28)
# ---------------------------------------------------------------------------

#: Table 1's diffusion length scales of the eight noise processes
KT_SCALES = (3.08e-5, 1.23e-4, 4.93e-4, 1.97e-3, 7.89e-3, 3.16e-2, 1.26e-1,
             5.05e-1)
#: the AR(1) decay exp(-lambda) per 6-hour step, lambda = 1
NOISE_PHI = float(np.exp(-1.0))


def noise_sigma_l(lmax: int) -> np.ndarray:
    """(8, L) float32 per-degree std of the eight AR(1) processes (unit
    pointwise variance in the stationary state), zero at l = 0."""
    l = np.arange(lmax, dtype=np.float64)
    out = np.zeros((len(KT_SCALES), lmax))
    for i, kt in enumerate(KT_SCALES):
        e = np.exp(-kt * l * (l + 1.0))
        denom = ((2.0 * l + 1.0) * e)[1:].sum()
        f0 = np.sqrt(2.0 * np.pi * (1.0 - NOISE_PHI ** 2) / max(denom, 1e-30))
        out[i] = f0 * np.sqrt(e)
    out[:, 0] = 0.0
    return out.astype(np.float32)


def noise_stationary_scale() -> float:
    """The stationary std over the innovation std, 1 / sqrt(1 - phi^2)."""
    return float(1.0 / np.sqrt(1.0 - NOISE_PHI ** 2))


def power_law_sigma_l(lmax: int, slope: float = 3.0, peak_l: int = 4,
                      band_limit: float = 0.85) -> np.ndarray:
    """(L,) float32 per-degree std of a band-limited atmospheric power
    law of unit pointwise variance."""
    ell = np.arange(lmax, dtype=np.float64)
    s = (1.0 + (ell / peak_l) ** slope) ** -1.0
    s[0] = 0.0
    s[ell > band_limit * lmax] = 0.0
    var = (s * (2 * ell + 1) / (4 * np.pi)).sum()
    return np.sqrt(s / var).astype(np.float32)


def white_coeffs(gen: torch.Generator, batch: tuple[int, ...],
                 sigma_l: torch.Tensor, lmax: int, mmax: int
                 ) -> torch.Tensor:
    """Orthonormal-basis white coefficients (*batch, L, M) complex64 on
    ``gen``'s device, scaled by ``sigma_l`` (..., L): real N(0, 1) at
    m = 0, complex with N(0, 1/2) parts above, zero for m > l."""
    dev = gen.device
    shape = tuple(batch) + (lmax, mmax)
    re = torch.randn(shape, generator=gen, device=dev)
    im = torch.randn(shape, generator=gen, device=dev)
    m = torch.arange(mmax, device=dev)
    scale = torch.where(m == 0, 1.0, math.sqrt(0.5))
    mask = torch.as_tensor(mode_mask(lmax, mmax), dtype=torch.float32,
                           device=dev)
    eta = torch.complex(re * scale, im * scale * (m != 0).float()) * mask
    return eta * sigma_l.to(dev)[..., :, None]
