"""Plain PyTorch FourCastNet 3: parameters, one 6-hour step, the fair
CRPS objective, the ensemble scores and Adam.

The mathematics of the paper's model (Bonev et al. 2025, Appendix C and
E), as the port computes it, written again with plain torch operations
and the tables of ``sphere.py``.  A step runs one member at a time, so
it fits beside nothing else on the card; with gradients on, each
processor block is recomputed in the backward pass.  ``ModelConfig`` is
the ``model`` group of a configuration file.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import sphere

#: Table 4's surface channel weights (u10m, v10m, u100m, v100m, t2m, msl,
#: tcwv); level p weighs p * 1e-3
SURFACE_WEIGHTS = (0.1, 0.1, 0.1, 0.1, 1.0, 0.1, 0.1)
PRESSURE_LEVELS = (50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925,
                   1000)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The widths of one FCN3 configuration (paper Table 2)."""

    nlat: int
    nlon: int
    grid: str
    latent_nlat: int
    latent_nlon: int
    latent_grid: str
    n_levels: int
    n_atmos: int
    n_surface: int
    n_aux: int
    n_noise: int
    atmos_embed: int
    surface_embed: int
    cond_embed: int
    n_blocks: int
    global_block_every: int
    mlp_hidden: int
    encoder_cutoff: float
    latent_cutoff: float
    filter_ell_max: int
    filter_m_max: int
    layer_scale_init: float

    @classmethod
    def of(cls, d: dict) -> "ModelConfig":
        """From a configuration file's ``model`` group (its keys exactly)."""
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})

    @property
    def n_state(self) -> int:
        """Prognostic channels."""
        return self.n_levels * self.n_atmos + self.n_surface

    @property
    def c_latent(self) -> int:
        """Latent channels."""
        return self.n_levels * self.atmos_embed + self.surface_embed

    @property
    def n_basis(self) -> int:
        """Morlet basis functions of every DISCO filter."""
        return len(sphere.morlet_spec(self.filter_ell_max, self.filter_m_max))

    def is_global(self, i: int) -> bool:
        """Whether processor block ``i`` is a global (spectral) one."""
        return i % self.global_block_every == 0

    def water_channels(self) -> np.ndarray:
        """Specific humidity at every level and tcwv: the softclamped ones."""
        nl = self.n_levels
        return np.concatenate([np.arange(4 * nl, 5 * nl),
                               [nl * self.n_atmos + 6]])

    def channel_weights(self) -> np.ndarray:
        """(C,) Table 4's loss weight of each state channel."""
        levels = np.asarray(PRESSURE_LEVELS[:self.n_levels], np.float64)
        return np.concatenate([np.tile(levels * 1e-3, self.n_atmos),
                               SURFACE_WEIGHTS[:self.n_surface]])


def param_specs(cfg: ModelConfig) -> list[tuple[str, tuple, float | None,
                                                 float]]:
    """Every parameter as (name, shape, std, constant): drawn N(0, std^2)
    when std is not None, else filled with the constant.  He-style
    scales (paper C.6): a DISCO weight std sqrt(gain / fan_in) with
    fan_in = (C_in / groups) * K, an MLP layer sqrt(2 / fan_in), a
    spectral filter sqrt(1 / C_in) for each of its two parts."""
    k = cfg.n_basis
    out = []

    def conv(name, c_out, c_in, groups, gain=1.0):
        cpg = c_in // groups
        out.append((f"{name}.weight", (c_out, cpg, k),
                    math.sqrt(gain / (cpg * k)), 0.0))
        out.append((f"{name}.bias", (c_out,), None, 0.0))

    conv("enc_atmos", cfg.atmos_embed, cfg.n_atmos, cfg.n_atmos)
    conv("enc_surface", cfg.surface_embed, cfg.n_surface, cfg.n_surface)
    conv("enc_cond", cfg.cond_embed, cfg.n_aux + cfg.n_noise,
         cfg.n_aux + cfg.n_noise)
    conv("dec_atmos", cfg.n_atmos, cfg.atmos_embed, cfg.n_atmos)
    conv("dec_surface", cfg.n_surface, cfg.surface_embed, cfg.n_surface)
    c, c_in, hid = cfg.c_latent, cfg.c_latent + cfg.cond_embed, cfg.mlp_hidden
    for i in range(cfg.n_blocks):
        p = f"blocks.{i}"
        if cfg.is_global(i):
            for part in ("w_re", "w_im"):
                out.append((f"{p}.conv.{part}", (c, c_in, cfg.latent_nlat),
                            math.sqrt(1.0 / c_in), 0.0))
        else:
            conv(f"{p}.conv", c, c_in, 1, gain=2.0)
        out += [(f"{p}.mlp.w1", (hid, c), math.sqrt(2.0 / c), 0.0),
                (f"{p}.mlp.b1", (hid,), None, 0.0),
                (f"{p}.mlp.w2", (c, hid), math.sqrt(2.0 / hid), 0.0),
                (f"{p}.mlp.b2", (c,), None, 0.0),
                (f"{p}.layer_scale", (c,), None, cfg.layer_scale_init)]
    return out


@dataclasses.dataclass
class Geometry:
    """Every table a step needs, worked out on ``device``: the three DISCO
    filters, the latent SHT, the upsample, and at IO resolution the SHT
    of the noise, the loss and the spectra."""

    cfg: ModelConfig
    enc: sphere.DiscoFilter
    latent: sphere.DiscoFilter
    dec: sphere.DiscoFilter
    latent_sht: sphere.SHT
    io_sht: sphere.SHT
    upsample: sphere.Bilinear
    area_weights: torch.Tensor

    @classmethod
    def create(cls, cfg: ModelConfig, device, dtype=torch.float32,
               io_tables=("wpct", "pct")) -> "Geometry":
        """Build every table from the grid sizes, in ``dtype``; at IO
        resolution only the SHT tables ``io_tables`` names (``pct`` for
        the noise and the perturbations, ``wpct`` for the loss and the
        spectra)."""
        gi = sphere.make_grid(cfg.nlat, cfg.nlon, cfg.grid)
        gl = sphere.make_grid(cfg.latent_nlat, cfg.latent_nlon,
                              cfg.latent_grid)
        filt = (cfg.filter_ell_max, cfg.filter_m_max)
        return cls(
            cfg=cfg,
            enc=sphere.DiscoFilter.create(gi, gl, device, *filt,
                                          cfg.encoder_cutoff, dtype),
            latent=sphere.DiscoFilter.create(gl, gl, device, *filt,
                                             cfg.latent_cutoff, dtype),
            dec=sphere.DiscoFilter.create(gi, gi, device, *filt,
                                          cfg.encoder_cutoff, dtype),
            latent_sht=sphere.SHT.create(gl, device, dtype=dtype),
            io_sht=sphere.SHT.create(gi, device, io_tables, dtype),
            upsample=sphere.Bilinear.create(gl, gi, device),
            area_weights=torch.as_tensor(gi.area_weights(), dtype=dtype,
                                         device=device))

    @property
    def dtype(self) -> torch.dtype:
        """The precision of every table and of the step."""
        return self.area_weights.dtype


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU."""
    return F.gelu(x, approximate="tanh")


def softclamp(u: torch.Tensor) -> torch.Tensor:
    """Paper eq. (29): 0 below 0, u^2 up to 1/2, u - 1/4 above."""
    return torch.where(u <= 0.0, torch.zeros_like(u),
                       torch.where(u <= 0.5, u * u, u - 0.25))


def _block(geo: Geometry, P: dict, i: int, x: torch.Tensor,
           zc: torch.Tensor) -> torch.Tensor:
    cfg, p = geo.cfg, f"blocks.{i}"
    h = torch.cat([x, zc], dim=1)
    if cfg.is_global(i):
        c = geo.latent_sht.forward(h)
        w = torch.complex(P[f"{p}.conv.w_re"], P[f"{p}.conv.w_im"])
        h = geo.latent_sht.inverse(torch.einsum("oil,nilm->nolm", w, c))
    else:
        h = sphere.disco_conv(geo.latent, h, P[f"{p}.conv.weight"],
                              P[f"{p}.conv.bias"], groups=1)
    h = gelu(h)
    h = gelu(torch.einsum("oc,nchw->nohw", P[f"{p}.mlp.w1"], h)
             + P[f"{p}.mlp.b1"][:, None, None])
    h = (torch.einsum("oc,nchw->nohw", P[f"{p}.mlp.w2"], h)
         + P[f"{p}.mlp.b2"][:, None, None])
    return x + P[f"{p}.layer_scale"][:, None, None] * h


def _member(geo: Geometry, P: dict, state: torch.Tensor,
            cond: torch.Tensor) -> torch.Tensor:
    """One member: state (1, C, H, W), cond (1, n_aux + n_noise, H, W)."""
    cfg = geo.cfg
    nl, na = cfg.n_levels, cfg.n_atmos
    h, w = state.shape[-2:]
    za = sphere.disco_conv(geo.enc, state[:, :nl * na].reshape(nl, na, h, w),
                           P["enc_atmos.weight"], P["enc_atmos.bias"], na)
    za = za.reshape((1, nl * cfg.atmos_embed) + za.shape[-2:])
    zs = sphere.disco_conv(geo.enc, state[:, nl * na:],
                           P["enc_surface.weight"], P["enc_surface.bias"],
                           cfg.n_surface)
    zc = sphere.disco_conv(geo.enc, cond, P["enc_cond.weight"],
                           P["enc_cond.bias"], cfg.n_aux + cfg.n_noise)
    x = torch.cat([za, zs], dim=1)
    del za, zs
    remat = torch.is_grad_enabled()
    for i in range(cfg.n_blocks):
        if remat:
            x = checkpoint(_block, geo, P, i, x, zc, use_reentrant=False)
        else:
            x = _block(geo, P, i, x, zc)
    up = geo.upsample(x)
    del x
    ne = nl * cfg.atmos_embed
    ua = sphere.disco_conv(geo.dec, up[:, :ne].reshape(
        (nl, cfg.atmos_embed) + up.shape[-2:]), P["dec_atmos.weight"],
        P["dec_atmos.bias"], na)
    us = sphere.disco_conv(geo.dec, up[:, ne:], P["dec_surface.weight"],
                           P["dec_surface.bias"], cfg.n_surface)
    del up
    out = torch.cat([ua.reshape((1, nl * na) + ua.shape[-2:]), us], dim=1)
    mask = torch.zeros((cfg.n_state,), dtype=torch.bool, device=out.device)
    mask[torch.as_tensor(cfg.water_channels(), device=out.device)] = True
    return torch.where(mask[:, None, None], softclamp(out), out)


def step(geo: Geometry, P: dict, state: torch.Tensor, cond: torch.Tensor
         ) -> torch.Tensor:
    """One 6-hour step of every member: state (..., C, H, W) and cond
    (..., n_aux + n_noise, H, W) with the same leading dims, in the
    geometry's precision (``P`` must be in it too)."""
    lead = state.shape[:-3]
    s = state.reshape((-1,) + state.shape[-3:]).to(geo.dtype)
    c = cond.reshape((-1,) + cond.shape[-3:]).to(geo.dtype)
    out = torch.cat([_member(geo, P, s[i:i + 1], c[i:i + 1])
                     for i in range(s.shape[0])])
    return out.reshape(lead + out.shape[1:])


# ---------------------------------------------------------------------------
# Noise conditioning and perturbations (paper B.7, E.2-E.3)
# ---------------------------------------------------------------------------

def noise_fields(geo: Geometry, z_hat: torch.Tensor, centered: bool
                 ) -> torch.Tensor:
    """(E, n_noise, L, M) coefficients -> (E, n_noise, H, W) fields; with
    centering member j takes member 2 (j // 2)'s field, negated for odd j."""
    e = z_hat.shape[0]
    if not centered:
        return geo.io_sht.inverse(z_hat)
    idx = torch.arange(e, device=z_hat.device)
    even = geo.io_sht.inverse(z_hat[0::2])
    sign = (1.0 - 2.0 * (idx % 2)).to(even.dtype)
    return even[idx // 2] * sign[:, None, None, None]


def obs_members(geo: Geometry, state0: torch.Tensor, coeffs: torch.Tensor,
                members: int, amplitude: float) -> torch.Tensor:
    """(E, C, H, W) antithetic members around ``state0``: member j adds
    +/- (j odd) draw j // 2's field, ``amplitude`` times unit variance."""
    fields = geo.io_sht.inverse(coeffs) * amplitude
    idx = torch.arange(members, device=state0.device)
    sign = (1.0 - 2.0 * (idx % 2)).to(fields.dtype)
    return state0[None].to(fields.dtype) + fields[idx // 2] * sign[
        :, None, None, None]


# ---------------------------------------------------------------------------
# Scores (paper Appendix D) and the objective (paper E.1)
# ---------------------------------------------------------------------------

def spatial_mean(x: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (...): area-weighted mean, by the weights' own sum."""
    return (torch.einsum("...hw,hw->...", x, aw)
            / torch.einsum("hw,hw->", torch.ones_like(aw), aw))


def crps_pointwise(ens: torch.Tensor, obs: torch.Tensor, fair: bool
                   ) -> torch.Tensor:
    """Ensemble CRPS along dim 0, eq. (46), or the fair form, eq. (47)."""
    e = ens.shape[0]
    err = (ens - obs[None]).abs().mean(dim=0)
    spread = (ens[:, None] - ens[None, :]).abs().mean(dim=(0, 1))
    corr = e / (e - 1.0) if fair and e > 1 else 1.0
    return err - 0.5 * corr * spread


def scores(geo: Geometry, ens: torch.Tensor, truth: torch.Tensor | None,
           spectra: bool) -> dict[str, torch.Tensor]:
    """One lead's scores of members (E, C, H, W), each per channel: fair
    CRPS, ensemble-mean RMSE, spread, spread-skill ratio and the rank
    histogram against ``truth``; the members' mean energy spectrum and
    the truth's with ``spectra``."""
    aw = geo.area_weights
    e = ens.shape[0]
    ens = ens.to(aw.dtype)
    truth = truth.to(aw.dtype) if truth is not None else None
    out = {}
    if truth is not None:
        out["crps"] = spatial_mean(crps_pointwise(ens, truth, True), aw)
        out["ens_rmse"] = torch.sqrt(spatial_mean(
            (ens.mean(dim=0) - truth) ** 2, aw))
        out["spread"] = torch.sqrt(spatial_mean(
            torch.var(ens, dim=0, correction=1), aw))
        out["ssr"] = math.sqrt((e + 1.0) / e) * out["spread"] / out["ens_rmse"]
        rank = (ens < truth[None]).sum(dim=0)                  # (C, H, W)
        counts = torch.stack([(rank == r).sum(dim=-1) for r in range(e + 1)],
                             dim=-1).to(aw.dtype)              # (C, H, E+1)
        out["rank_hist"] = torch.einsum("chr,h->cr", counts, aw[:, 0])
    if spectra:
        out["spectrum"] = torch.stack([
            sphere.power_spectrum(geo.io_sht.forward(m)) for m in ens]).mean(0)
        if truth is not None:
            out["spectrum_truth"] = sphere.power_spectrum(
                geo.io_sht.forward(truth))
    return out


def spectral_weights(lmax: int, mmax: int) -> np.ndarray:
    """Eq. (51): the valid slots, orders m > 0 twice, over the real
    degrees of freedom."""
    mult = np.concatenate([[1.0], np.full((mmax - 1,), 2.0)])
    w = sphere.mode_mask(lmax, mmax) * mult[None, :]
    return w / w.sum()


def objective(geo: Geometry, ens: torch.Tensor, obs: torch.Tensor,
              fair: bool, lambda_spectral: float = 1.0) -> torch.Tensor:
    """Eq. (48): ens (E, B, C, H, W) against obs (B, C, H, W): the
    channel-weighted nodal CRPS, eq. (50), plus the spectral CRPS, eq.
    (51), each averaged over the batch."""
    cw = torch.as_tensor(geo.cfg.channel_weights(), dtype=torch.float32,
                         device=ens.device)
    cw = cw / cw.sum()
    nodal = torch.einsum("bchw,hw->bc", crps_pointwise(ens, obs, fair),
                         geo.area_weights)
    ce, co = geo.io_sht.forward(ens), geo.io_sht.forward(obs)
    w_lm = torch.as_tensor(spectral_weights(*ce.shape[-2:]),
                           dtype=torch.float32, device=ens.device)
    spec = torch.einsum("bclm,lm->bc",
                        crps_pointwise(ce.real, co.real, fair)
                        + crps_pointwise(ce.imag, co.imag, fair), w_lm)
    return (nodal @ cw).mean() + lambda_spectral * (spec @ cw).mean()


# ---------------------------------------------------------------------------
# Adam (Kingma & Ba 2014) with global-norm clipping and the halving
# schedule of paper Table 3
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Adam:
    """Adam over a dict of float32 tensors, updated in place."""

    lr: float
    halve_every: int | None
    clip_norm: float | None = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def __post_init__(self):
        self.t = 0
        self.mu: dict = {}
        self.nu: dict = {}

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> dict:
        """One step; returns the gradients as clipped (the moments'
        input)."""
        if self.clip_norm is not None:
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-9),
                                max=1.0)
            grads = {k: g * scale for k, g in grads.items()}
        self.t += 1
        lr = self.lr * (0.5 ** (self.t // self.halve_every)
                        if self.halve_every else 1.0)
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = self.b1 * self.mu.get(k, 0.0) + (1 - self.b1) * g
            self.nu[k] = self.b2 * self.nu.get(k, 0.0) + (1 - self.b2) * g * g
            p -= lr * ((self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2)
                                             + self.eps))
        return grads
