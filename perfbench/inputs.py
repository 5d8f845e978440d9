"""Every input of a run, made from ``--seed``: the weights, the states,
the auxiliary fields, the truth and the noise and perturbation draws.

The same seed gives the same values, and the program and the reference
are handed the same ones.  The fields come from a frozen copy of the
synthetic ERA5 surrogate (Gaussian random fields with a band-limited
power-law spectrum, a zonal climatology and AR(1) persistence between
6-hourly offsets); the weights are drawn on the device in one call at
the model's own shapes and scales.  Nothing here reads the program.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import fcn3 as ref
from perfbench.reference import sphere

#: 6-hour autocorrelation and spectrum of the synthetic state
AR1_RHO, SLOPE, PEAK_L = 0.95, 3.0, 4


def sub_seed(seed: int, *salt) -> int:
    """A 63-bit generator seed for one use of ``seed``."""
    text = ":".join(str(s) for s in (seed,) + salt).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *salt) -> torch.Generator:
    """A generator on ``device`` seeded for one use of ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *salt))
    return g


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

@torch.no_grad()
def draw_weights(cfg: ref.ModelConfig, seed: int, device) -> dict:
    """Every parameter of ``ref.param_specs`` from one normal draw on
    ``device`` (float32, the type the model is served in)."""
    specs = ref.param_specs(cfg)
    n = sum(int(np.prod(shape)) for _, shape, std, _ in specs
            if std is not None)
    flat = torch.randn((n,), generator=generator(device, seed, "weights"),
                       device=device)
    out, at = {}, 0
    for name, shape, std, const in specs:
        size = int(np.prod(shape))
        if std is None:
            out[name] = torch.full(shape, const, device=device)
        else:
            out[name] = flat[at:at + size].view(shape) * std
            at += size
    return out


@torch.no_grad()
def load_weights(model: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into the model's parameters, name for name; the
    two sets of names and shapes must be equal."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the benchmark draws {sorted(set(weights))[:5]}..."
                         f" and the model has {sorted(set(params))[:5]}...: "
                         f"{sorted(set(params) ^ set(weights))[:8]} differ")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: the model's {tuple(p.shape)}, the "
                             f"benchmark's {tuple(weights[name].shape)}")
        p.copy_(weights[name])


# ---------------------------------------------------------------------------
# Fields
# ---------------------------------------------------------------------------

def cos_zenith(grid: sphere.Grid, t_hours: float) -> np.ndarray:
    """(H, W) cosine of the solar zenith angle at ``t_hours``, >= 0."""
    day = t_hours / 24.0
    decl = np.deg2rad(23.44) * np.sin(2 * np.pi * (day - 81.0) / 365.25)
    lat = np.pi / 2 - grid.colat
    ha = (t_hours % 24.0) / 24.0 * 2 * np.pi + grid.lons[None, :] - np.pi
    cz = (np.sin(lat)[:, None] * np.sin(decl)
          + np.cos(lat)[:, None] * np.cos(decl) * np.cos(ha))
    return np.maximum(cz, 0.0)


class Fields:
    """The synthetic surrogate on ``cfg``'s IO grid, made on ``device``."""

    def __init__(self, cfg: ref.ModelConfig, device):
        self.cfg = cfg
        self.device = device
        self.grid = sphere.make_grid(cfg.nlat, cfg.nlon, cfg.grid)
        self.sht = sphere.SHT.create(self.grid, device, need=("pct",))
        sig = sphere.power_law_sigma_l(self.sht.lmax, SLOPE, PEAK_L)
        self.coeff_scale = torch.as_tensor(
            sphere.mode_mask(self.sht.lmax, self.sht.mmax) * sig[:, None],
            dtype=torch.float32, device=device)

    def static_aux(self) -> np.ndarray:
        """(3, H, W): land mask, sea mask, orography."""
        lat = np.pi / 2 - self.grid.colat[:, None]
        lon = self.grid.lons[None, :]
        conts = (np.sin(2 * lat) * np.cos(3 * lon)
                 + 0.5 * np.sin(5 * lat + 1.3) * np.sin(2 * lon + 0.7))
        land = (conts > 0.15).astype(np.float32)
        oro = np.maximum(conts - 0.15, 0.0) * 2.0
        return np.stack([land, 1.0 - land, oro]).astype(np.float32)

    def aux(self, t_hours: float) -> np.ndarray:
        """(n_aux, H, W) float32 host array at ``t_hours``."""
        cz = cos_zenith(self.grid, t_hours).astype(np.float32)
        return np.concatenate([self.static_aux(), cz[None]])

    def _field(self, g: torch.Generator, n: int) -> torch.Tensor:
        shape = (n, self.sht.lmax, self.sht.mmax)
        re = torch.randn(shape, generator=g, device=self.device)
        im = torch.randn(shape, generator=g, device=self.device)
        m = torch.arange(self.sht.mmax, device=self.device)
        half = float(np.sqrt(0.5))
        c = torch.complex(re * torch.where(m == 0, 1.0, half),
                          im * torch.where(m == 0, 0.0, half))
        return self.sht.inverse(c * self.coeff_scale)

    def _finish(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg.n_state
        colat = torch.as_tensor(self.grid.colat, dtype=torch.float32,
                                device=self.device)
        chan = torch.arange(c, dtype=torch.float32, device=self.device)
        x = x + (0.5 * torch.cos(colat)[None, :, None]
                 * torch.cos(chan * 0.37)[:, None, None])
        mask = torch.zeros((c,), dtype=torch.bool, device=self.device)
        mask[torch.as_tensor(self.cfg.water_channels(),
                             device=self.device)] = True
        return torch.where(mask[:, None, None], F.softplus(x), x)

    def trajectory(self, seed: int, sample: int, steps: int
                   ) -> list[torch.Tensor]:
        """States (C, H, W) at offsets 0..steps of one sample, each AR(1)
        correlated with the one before."""
        rho = AR1_RHO
        x = self._field(generator(self.device, seed, "field", sample, 0),
                        self.cfg.n_state)
        out = [self._finish(x)]
        for k in range(1, steps + 1):
            x = rho * x + np.sqrt(1 - rho * rho) * self._field(
                generator(self.device, seed, "field", sample, k),
                self.cfg.n_state)
            out.append(self._finish(x))
        return out


# ---------------------------------------------------------------------------
# Noise and perturbation draws
# ---------------------------------------------------------------------------

class NoiseDraws:
    """The AR(1) noise process's white draws for members of shape
    ``batch``: ``z_hat0`` the stationary initial state and ``self[n]``
    the innovation after lead ``n``, each drawn on the device from its
    own generator, so any lead's draw is made alone."""

    def __init__(self, cfg: ref.ModelConfig, seed: int, salt: str,
                 batch: tuple[int, ...], device):
        self.seed, self.salt, self.device = seed, salt, device
        self.batch = tuple(batch) + (cfg.n_noise,)
        self.lmax = cfg.nlat
        self.mmax = min(cfg.nlat, cfg.nlon // 2 + 1)
        self.sigma_l = torch.as_tensor(sphere.noise_sigma_l(self.lmax),
                                       device=device)

    def _draw(self, *salt) -> torch.Tensor:
        return sphere.white_coeffs(
            generator(self.device, self.seed, self.salt, *salt), self.batch,
            self.sigma_l, self.lmax, self.mmax)

    def z_hat0(self) -> torch.Tensor:
        """(*batch, n_noise, L, M) initial coefficients."""
        return self._draw("z0") * sphere.noise_stationary_scale()

    def __getitem__(self, n: int) -> torch.Tensor:
        return self._draw("eta", int(n))

    def z_hat(self, n: int) -> torch.Tensor:
        """The coefficients at lead ``n``: z_{k+1} = phi z_k + eta_k."""
        z = self.z_hat0()
        for k in range(n):
            z = sphere.NOISE_PHI * z + self[k]
        return z


def perturbation_coeffs(cfg: ref.ModelConfig, seed: int, draws: int,
                        device) -> torch.Tensor:
    """(draws, C, L, M) white coefficients with the surrogate's power-law
    spectrum: the observation-error perturbations' draws."""
    lmax = cfg.nlat
    mmax = min(lmax, cfg.nlon // 2 + 1)
    sig = torch.as_tensor(sphere.power_law_sigma_l(lmax), device=device)
    return sphere.white_coeffs(generator(device, seed, "perturb"),
                               (draws, cfg.n_state), sig, lmax, mmax)
