"""Synthetic ERA5-like states and auxiliary fields, generated on the device,
and the sharded batch loader training reads them through.

Each variable is a Gaussian random field with a band-limited atmospheric
power-law spectrum, a zonally varying climatology and AR(1) persistence
between 6-hourly offsets, as in the JAX package.  Fields are
reproducible from (sample index, offset) alone: each draw seeds its own
``torch.Generator``.  The random numbers differ from the JAX package's
(threefry cannot be reproduced); tests that compare the two packages
hand the same numpy arrays to both.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.fcn3 import FCN3Config
from repro_torch.core.sphere import grids as glib
from repro_torch.core.sphere import noise as noiselib
from repro_torch.core.sphere import sht as shtlib
from repro_torch.distributed.compat import row_block
from repro_torch.runtime import resolve_device

_SEED_BASE = 20200101


def cos_zenith_angle(colat: np.ndarray, lons: np.ndarray,
                     t_hours: float) -> np.ndarray:
    """Analytic cosine solar zenith angle on the grid at time t (hours)."""
    day = t_hours / 24.0
    decl = np.deg2rad(23.44) * np.sin(2 * np.pi * (day - 81.0) / 365.25)
    lat = np.pi / 2 - colat
    hour = (t_hours % 24.0) / 24.0 * 2 * np.pi
    ha = hour + lons[None, :] - np.pi
    cz = (np.sin(lat)[:, None] * np.sin(decl)
          + np.cos(lat)[:, None] * np.cos(decl) * np.cos(ha))
    return np.maximum(cz, 0.0)


@dataclasses.dataclass(frozen=True)
class SyntheticERA5:
    """Deterministic spectral surrogate of the 72-channel ERA5 subset."""

    cfg: FCN3Config
    device: str | torch.device | None = None
    ar1_rho: float = 0.95        # 6-hour autocorrelation
    spectral_slope: float = 3.0  # PSD ~ l^-slope
    peak_l: int = 4              # synoptic energy peak

    @functools.cached_property
    def dev(self) -> torch.device:
        """The resolved device the fields are made on."""
        return resolve_device(self.device)

    @functools.cached_property
    def grid(self) -> glib.SphereGrid:
        """The data grid."""
        return glib.make_grid(self.cfg.nlat, self.cfg.nlon, self.cfg.grid)

    @functools.cached_property
    def sht(self) -> shtlib.SHT:
        """The SHT of the data grid."""
        return shtlib.SHT.create(self.grid)

    @functools.cached_property
    def _pct(self) -> torch.Tensor:
        _, pbar = self.sht.tables()
        return torch.from_numpy(pbar.astype(np.float32)).to(self.dev)

    @functools.cached_property
    def spectrum_sigma_l(self) -> np.ndarray:
        """(L,) per-degree std of the surrogate's angular spectrum, shared
        with the obs-error initial-condition perturbations so perturbed
        members carry the data's spectral signature."""
        return noiselib.power_law_sigma_l(self.sht.lmax, self.spectral_slope,
                                          self.peak_l)

    def channel_std(self, n: int = 8) -> np.ndarray:
        """(C,) climatological per-channel std over ``n`` deterministic
        samples: the obs-error scaling of paper App. E (real ERA5 would
        read it from the normalization statistics)."""
        x = torch.stack([self.state(i) for i in range(n)])
        return x.std(dim=(0, 2, 3), correction=0).cpu().numpy()

    @functools.cached_property
    def _coeff_scale(self) -> torch.Tensor:
        """(L, M) per-coefficient std: power-law sigma_l on valid slots."""
        mask = shtlib.mode_mask(self.sht.lmax, self.sht.mmax).astype(
            np.float32)
        return torch.from_numpy(mask * self.spectrum_sigma_l[:, None]).to(
            self.dev)

    # -- auxiliary fields ------------------------------------------------
    @functools.cached_property
    def static_aux(self) -> np.ndarray:
        """(3, H, W): land mask, sea mask, orography (deterministic)."""
        g = self.grid
        lat = np.pi / 2 - g.colat[:, None]
        lon = g.lons[None, :]
        conts = (np.sin(2 * lat) * np.cos(3 * lon)
                 + 0.5 * np.sin(5 * lat + 1.3) * np.sin(2 * lon + 0.7))
        land = (conts > 0.15).astype(np.float32)
        oro = np.maximum(conts - 0.15, 0.0).astype(np.float32) * 2.0
        return np.stack([land, 1.0 - land, oro]).astype(np.float32)

    def aux_fields(self, t_hours: float) -> torch.Tensor:
        """(n_aux, H, W): static aux + cosine zenith at time t, on device."""
        cz = cos_zenith_angle(self.grid.colat, self.grid.lons,
                              t_hours).astype(np.float32)
        aux = np.concatenate([self.static_aux, cz[None]], axis=0)
        return torch.from_numpy(aux).to(self.dev)

    # -- prognostic state --------------------------------------------------
    def _field(self, seed: int, n: int) -> torch.Tensor:
        """n random band-limited fields with the atmospheric spectrum."""
        g = torch.Generator(device=self.dev)
        g.manual_seed(seed)
        shape = (n, self.sht.lmax, self.sht.mmax)
        re = torch.randn(shape, generator=g, device=self.dev)
        im = torch.randn(shape, generator=g, device=self.dev)
        m = torch.arange(self.sht.mmax, device=self.dev)
        half = float(np.sqrt(0.5))
        re = re * torch.where(m == 0, 1.0, half)
        im = im * torch.where(m == 0, 0.0, half)
        c = torch.complex(re, im) * self._coeff_scale
        return shtlib.sht_inverse(c, self._pct, self.grid.nlon)

    def state(self, sample_idx: int, t_offset_steps: int = 0
              ) -> torch.Tensor:
        """(C, H, W) normalized state; consecutive offsets are AR(1)
        correlated and (idx, offset) -> field is deterministic."""
        c = self.cfg.n_state

        def seed(k: int) -> int:
            return (_SEED_BASE * 1_000_003 + sample_idx) * 4099 + k

        x = self._field(seed(0), c)
        rho = self.ar1_rho
        for k in range(1, t_offset_steps + 1):
            x = rho * x + np.sqrt(1 - rho * rho) * self._field(seed(k), c)
        # zonally varying climatology offset per channel
        colat = torch.from_numpy(self.grid.colat.astype(np.float32)).to(
            self.dev)
        chan = torch.arange(c, dtype=torch.float32, device=self.dev)
        x = x + (0.5 * torch.cos(colat)[None, :, None]
                 * torch.cos(chan * 0.37)[:, None, None])
        # water channels: shift positive (min-max style normalization, E.4)
        mask = torch.zeros((c,), dtype=torch.bool, device=self.dev)
        mask[torch.from_numpy(self.cfg.water_channel_indices())] = True
        return torch.where(mask[:, None, None], F.softplus(x), x)

    def sample_pair(self, sample_idx: int, rollout: int = 1
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(input (C,H,W), targets (T,C,H,W), aux (T, n_aux, H, W))."""
        x0 = self.state(sample_idx, 0)
        targets = torch.stack([self.state(sample_idx, k)
                               for k in range(1, rollout + 1)])
        t0 = (sample_idx % 1460) * 6.0
        aux = torch.stack([self.aux_fields(t0 + 6.0 * k)
                           for k in range(rollout)])
        return x0, targets, aux


@dataclasses.dataclass
class Loader:
    """Sharded batch iterator.

    Each data-parallel rank generates only its ``rank``-th slice of the
    global batch; with ``lat_shard = (i, n)`` it also keeps only its
    latitude band, ``compat.row_block``'s rows, as the JAX package's
    loader does.
    """

    ds: SyntheticERA5
    global_batch: int
    rollout: int = 1
    rank: int = 0
    world: int = 1
    lat_shard: tuple[int, int] = (0, 1)
    seed: int = 0

    def __post_init__(self):
        if self.global_batch % self.world:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.world} ranks")
        self._step = 0

    def __iter__(self):
        self._step = 0
        return self

    def local_batch(self) -> int:
        """Samples this rank generates per batch."""
        return self.global_batch // self.world

    def __next__(self) -> dict[str, torch.Tensor]:
        b = self.local_batch()
        idx0 = self.seed * 10_000_000 + self._step * self.global_batch
        ids = [idx0 + self.rank * b + j for j in range(b)]
        xs, ys, aux = zip(*(self.ds.sample_pair(i, self.rollout)
                            for i in ids))
        batch = {"state": torch.stack(xs), "targets": torch.stack(ys),
                 "aux": torch.stack(aux)}
        i, n = self.lat_shard
        if n > 1:
            lo, hi = row_block(batch["state"].shape[-2], i, n)
            # copies, so that the whole field is freed
            batch = {k: v[..., lo:hi, :].clone(
                memory_format=torch.contiguous_format)
                for k, v in batch.items()}
        self._step += 1
        return batch


def climatology(ds: SyntheticERA5, n: int = 8) -> torch.Tensor:
    """(C, H, W) climatological mean over ``n`` deterministic samples."""
    return torch.stack([ds.state(i) for i in range(n)]).mean(dim=0)
