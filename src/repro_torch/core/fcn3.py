"""The FourCastNet 3 model (paper Section 3 / Appendix C).

  u_n (721x1440 equiangular, 72 channels)
    -> grouped DISCO encoders, no channel mixing           (C.3)
    -> latent (360x720 Gaussian, 641 channels)
    -> 10 processor blocks (2 global spectral, 8 local DISCO),
       conditioned on the auxiliary + noise embedding    (C.5)
    -> bilinear upsample + grouped DISCO decoders          (C.4)
    -> softclamp on water channels                         (C.8)

``FCN3`` is an ``nn.Module`` whose parameter names map 1:1 onto the JAX
package's parameter tree (``blocks.0.conv.w_re`` <-> ``blocks/0/conv/w_re``).
Parameters are built frozen; ``model.requires_grad_(True)`` makes them
trainable (the trainer does), and serving runs under ``inference_mode``.
Static geometry (DISCO filters, Legendre tables) travels in a separate
``buffers`` dict from ``make_buffers``, in the layout ``cfg.kernels``
selects.  ``forward(buffers, state, cond_in)`` is the JAX ``FCN3.apply``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import telemetry
from repro_torch.core import blocks as blk
from repro_torch.core.sphere import disco as discolib
from repro_torch.core.sphere import grids as glib
from repro_torch.core.sphere import interp as interplib
from repro_torch.core.sphere import noise as noiselib
from repro_torch.core.sphere import sht as shtlib
from repro_torch.kernels.config import KernelConfig
from repro_torch.runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class FCN3Config:
    """FCN3 hyperparameters (Table 2 defaults = the paper's 710M model)."""

    # grids
    nlat: int = 721
    nlon: int = 1440
    grid: str = "equiangular"
    latent_nlat: int = 360
    latent_nlon: int = 720
    latent_grid: str = "gauss"
    # variables
    n_levels: int = 13
    n_atmos: int = 5          # z, t, u, v, q per level
    n_surface: int = 7        # u10m, v10m, u100m, v100m, t2m, msl, tcwv
    n_aux: int = 4            # lsm-land, lsm-sea, orography, cos zenith
    n_noise: int = 8
    # embedding dims (Table 2)
    atmos_embed: int = 45     # per level
    surface_embed: int = 56
    cond_embed: int = 36
    # processor
    n_blocks: int = 10
    global_block_every: int = 5   # blocks 0, 5 are global: 2 global + 8 local
    mlp_hidden: int = 1282
    # filters
    encoder_cutoff: float = 3.0
    latent_cutoff: float = 3.0
    filter_ell_max: int = 2
    filter_m_max: int = 2
    layer_scale_init: float = 1e-3
    # path of the hot contractions; also decides the buffer layout
    kernels: KernelConfig = KernelConfig()

    @property
    def n_state(self) -> int:
        """Prognostic channels: atmospheric levels plus surface."""
        return self.n_levels * self.n_atmos + self.n_surface

    @property
    def n_cond_in(self) -> int:
        """Conditioning channels: auxiliary fields plus noise."""
        return self.n_aux + self.n_noise

    @property
    def c_latent(self) -> int:
        """Channels of the latent state."""
        return self.n_levels * self.atmos_embed + self.surface_embed

    def water_channel_indices(self) -> np.ndarray:
        """Channel order: [13*z, 13*t, 13*u, 13*v, 13*q, surface...]."""
        q = np.arange(4 * self.n_levels, 5 * self.n_levels)
        tcwv = np.array([self.n_levels * self.n_atmos + 6])
        return np.concatenate([q, tcwv])

    def block_specs(self) -> list[blk.BlockSpec]:
        """The ``BlockSpec`` of every processor block, in order."""
        n_basis = len(discolib.morlet_basis_spec(self.filter_ell_max,
                                                 self.filter_m_max))
        specs = []
        for i in range(self.n_blocks):
            is_global = (i % self.global_block_every) == 0
            specs.append(blk.BlockSpec(
                kind="global" if is_global else "local",
                c_latent=self.c_latent, c_cond=self.cond_embed,
                mlp_hidden=self.mlp_hidden, n_basis=n_basis,
                lmax=self.latent_nlat,
                layer_scale_init=self.layer_scale_init,
            ))
        return specs


def geometry(cfg: FCN3Config) -> dict:
    """The grids, the DISCO plans' arguments and the SHTs of a model of
    ``cfg``, without building any plan or table: ``grid_in`` /
    ``grid_latent``, ``enc`` / ``latent`` / ``dec`` (the arguments of
    ``disco.make_disco_plan``) and ``in_sht`` / ``latent_sht``."""
    grid_in = glib.make_grid(cfg.nlat, cfg.nlon, cfg.grid)
    grid_latent = glib.make_grid(cfg.latent_nlat, cfg.latent_nlon,
                                 cfg.latent_grid)
    filt = (cfg.filter_ell_max, cfg.filter_m_max)
    return {
        "grid_in": grid_in, "grid_latent": grid_latent,
        "enc": (grid_in, grid_latent, *filt, cfg.encoder_cutoff),
        "latent": (grid_latent, grid_latent, *filt, cfg.latent_cutoff),
        "dec": (grid_in, grid_in, *filt, cfg.encoder_cutoff),
        "in_sht": shtlib.SHT.create(grid_in),
        "latent_sht": shtlib.SHT.create(grid_latent),
    }


def geometry_keys(cfg: FCN3Config) -> list[tuple[str, tuple]]:
    """The cache keys of the plans a model of ``cfg`` needs, as
    ``("disco", disco.plan_key(...))`` and ``("legendre",
    legendre.table_key(...))`` pairs, each once."""
    from repro_torch.core.sphere import legendre as leg
    geo = geometry(cfg)
    keys = [("disco", discolib.plan_key(*geo[name]))
            for name in ("enc", "latent", "dec")]
    keys += [("legendre", leg.table_key(sht.lmax, sht.mmax, sht.grid.colat))
             for sht in (geo["in_sht"], geo["latent_sht"])]
    return list(dict.fromkeys(keys))


class FCN3(nn.Module):
    """FCN3 parameters plus the host-side geometry plans of one config.

    ``device`` is where parameters and buffers live: ``cuda`` unless the
    caller passes ``"cpu"`` (see ``repro_torch.runtime``).
    """

    def __init__(self, cfg: FCN3Config, device: str | torch.device | None
                 = None):
        super().__init__()
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        geo = geometry(cfg)
        self.grid_in, self.grid_latent = geo["grid_in"], geo["grid_latent"]
        self.enc_plan, self.latent_plan, self.dec_plan = (
            discolib.make_disco_plan(*geo[name])
            for name in ("enc", "latent", "dec"))
        self.latent_sht = geo["latent_sht"]
        self.in_sht = geo["in_sht"]  # noise at IO res
        self.upsample = interplib.BilinearResample.create(self.grid_latent,
                                                          self.grid_in)
        self.noise = noiselib.SphericalDiffusion(sht=self.in_sht)
        self.n_basis = nb = self.enc_plan.n_basis
        self._noise_buffers: dict | None = None

        # Encoders (C.3): grouped per variable, no channel mixing; the
        # atmospheric encoder is shared across pressure levels.
        self.enc_atmos = discolib.DiscoConv(
            cfg.atmos_embed, cfg.n_atmos, nb, groups=cfg.n_atmos, device=dev)
        self.enc_surface = discolib.DiscoConv(
            cfg.surface_embed, cfg.n_surface, nb, groups=cfg.n_surface,
            device=dev)
        self.enc_cond = discolib.DiscoConv(
            cfg.cond_embed, cfg.n_cond_in, nb, groups=cfg.n_cond_in,
            device=dev)
        # Decoders (C.4): grouped DISCO at native resolution.
        self.dec_atmos = discolib.DiscoConv(
            cfg.n_atmos, cfg.atmos_embed, nb, groups=cfg.n_atmos, device=dev)
        self.dec_surface = discolib.DiscoConv(
            cfg.n_surface, cfg.surface_embed, nb, groups=cfg.n_surface,
            device=dev)
        self.blocks = nn.ModuleList(blk.Block(spec, device=dev)
                                    for spec in cfg.block_specs())
        mask = np.zeros((cfg.n_state,), bool)
        mask[cfg.water_channel_indices()] = True
        self.register_buffer("water_mask",
                             torch.from_numpy(mask).to(dev)[:, None, None],
                             persistent=False)

    # ------------------------------------------------------------------
    def make_buffers(self) -> dict:
        """Geometry tensors on the model's device, in the layout
        ``cfg.kernels`` selects (banded DISCO split for "kernel")."""
        dev, kc = self.device, self.cfg.kernels
        return {
            "enc": self.enc_plan.buffers(dev, kc),
            "latent": self.latent_plan.buffers(dev, kc),
            "dec": self.dec_plan.buffers(dev, kc),
            "latent_sht": self.latent_sht.buffers(dev),
        }

    def buffer_specs(self) -> dict:
        """``make_buffers``' keys, shapes and dtypes as ``meta`` tensors
        (the JAX ``FCN3.buffer_specs``)."""
        kc = self.cfg.kernels
        return {
            "enc": self.enc_plan.buffer_specs(kc),
            "latent": self.latent_plan.buffer_specs(kc),
            "dec": self.dec_plan.buffer_specs(kc),
            "latent_sht": self.latent_sht.buffer_specs(),
        }

    def noise_buffers(self) -> dict:
        """The noise process's tables on the model's device (built once:
        the IO-resolution ``pct`` is 1.5 GB at 721x1440)."""
        if self._noise_buffers is None:
            self._noise_buffers = self.noise.buffers(self.device)
        return self._noise_buffers

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Draw every parameter afresh from ``generator`` (JAX ``init``'s
        names, shapes and distributions; different random numbers)."""
        for conv in (self.enc_atmos, self.enc_surface, self.enc_cond,
                     self.dec_atmos, self.dec_surface):
            conv.reset(generator)
        for b in self.blocks:
            b.reset(generator)

    @torch.no_grad()
    def init_calibrated(self, generator: torch.Generator,
                        state: torch.Tensor, cond_in: torch.Tensor,
                        buffers: dict | None = None, rounds: int = 4
                        ) -> None:
        """``init`` followed by ``calibrate`` (paper C.6 / Fig. 11)."""
        self.init(generator)
        self.calibrate(state, cond_in, buffers, rounds)

    @torch.no_grad()
    def calibrate(self, state: torch.Tensor, cond_in: torch.Tensor,
                  buffers: dict | None = None, rounds: int = 4) -> None:
        """LSUV-style variance calibration of the current parameters.

        Encoder and decoder weights are rescaled by scalars so the latent
        embeddings and the one-step output keep the input's standard
        deviation (population std, as ``jnp.std``); the calibration state
        then advances to the model's own output and the scales are redone,
        ``rounds`` times.
        """
        cfg = self.cfg
        bufs = buffers if buffers is not None else self.make_buffers()
        target = float(state.std(correction=0))
        na = cfg.n_levels * cfg.atmos_embed
        nl = cfg.n_levels * cfg.n_atmos

        def std(t: torch.Tensor) -> float:
            return float(t.std(correction=0)) or 1.0

        x = state
        for _ in range(rounds):
            # 1) encoders -> unit-std latent / conditioning embeddings.
            z, c = self._encode(bufs, x, cond_in)
            self.enc_atmos.weight.mul_(1.0 / std(z[..., :na, :, :]))
            self.enc_surface.weight.mul_(1.0 / std(z[..., na:, :, :]))
            self.enc_cond.weight.mul_(1.0 / std(c))
            del z, c
            # 2) decoder -> one full step preserves the state's std.
            out = self(bufs, x, cond_in)
            self.dec_atmos.weight.mul_(target / std(out[..., :nl, :, :]))
            self.dec_surface.weight.mul_(target / std(out[..., nl:, :, :]))
            del out
            # 3) advance the calibration state to the model's own output.
            x = self(bufs, x, cond_in)

    # ------------------------------------------------------------------
    def _encode(self, buffers: dict, state: torch.Tensor,
                cond_in: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        nl, na = cfg.n_levels, cfg.n_atmos
        stride = self.enc_plan.stride
        b = state.shape[:-3]
        hw = state.shape[-2:]
        # (..., L, A, H, W): shared encoder applied per level.
        atmos = state[..., : nl * na, :, :].reshape(b + (nl, na) + hw)
        surface = state[..., nl * na:, :, :]
        kc = cfg.kernels
        za = self.enc_atmos(atmos, buffers["enc"], stride, kernels=kc)
        za = za.reshape(b + (nl * cfg.atmos_embed,) + za.shape[-2:])
        zs = self.enc_surface(surface, buffers["enc"], stride, kernels=kc)
        zc = self.enc_cond(cond_in, buffers["enc"], stride, kernels=kc)
        return torch.cat([za, zs], dim=-3), zc

    def _decode(self, buffers: dict, latent: torch.Tensor) -> torch.Tensor:
        return self._decoders(buffers, self.upsample(latent))

    def _decoders(self, buffers: dict, up: torch.Tensor) -> torch.Tensor:
        """The two grouped decoders on the upsampled latent ``up``
        (..., C_latent, H_in, W) -> (..., n_state, H_out, W), H_out the
        rows of ``buffers["dec"]``."""
        cfg = self.cfg
        nl = cfg.n_levels
        b = up.shape[:-3]
        hw = up.shape[-2:]
        atmos_lat = up[..., : nl * cfg.atmos_embed, :, :].reshape(
            b + (nl, cfg.atmos_embed) + hw)
        surf_lat = up[..., nl * cfg.atmos_embed:, :, :]
        del up
        kc = cfg.kernels
        ua = self.dec_atmos(atmos_lat, buffers["dec"], 1, kernels=kc)
        ua = ua.reshape(b + (nl * cfg.n_atmos,) + ua.shape[-2:])
        us = self.dec_surface(surf_lat, buffers["dec"], 1, kernels=kc)
        return torch.cat([ua, us], dim=-3)

    def forward(self, buffers: dict, state: torch.Tensor,
                cond_in: torch.Tensor) -> torch.Tensor:
        """One 6-hour step (JAX ``FCN3.apply``).

        state: (..., n_state, H, W); cond_in: (..., n_aux + n_noise, H, W).
        Returns u_{n+1}, same shape as ``state`` (direct prediction, C.7).
        With gradients on each processor block is rematerialised.  The
        spans bracket the calls here, so the recomputation in backward
        is not spanned.
        """
        with telemetry.span("fcn3.forward"):
            with telemetry.span("fcn3.encoder"):
                x, cond = self._encode(buffers, state, cond_in)
            remat = torch.is_grad_enabled() and (
                x.requires_grad
                or any(p.requires_grad for p in self.blocks.parameters()))
            for i, block in enumerate(self.blocks):
                local = block.spec.kind == "local"
                buf = buffers["latent"] if local else buffers["latent_sht"]
                with telemetry.span("fcn3.block.local" if local
                                    else "fcn3.block.global", index=i):
                    if remat:
                        # recompute each block in backward, keeping only
                        # its inputs (the JAX model's jax.checkpoint per
                        # block)
                        x = checkpoint(block, x, cond, buf, self.cfg.kernels,
                                       use_reentrant=False)
                    else:
                        x = block(x, cond, buf, kernels=self.cfg.kernels)
            del cond
            with telemetry.span("fcn3.decoder"):
                out = self._decode(buffers, x)
                # Output transformation (C.8): softclamp water channels.
                return torch.where(self.water_mask, blk.softclamp(out), out)

    # ------------------------------------------------------------------
    def sample_noise(self, generator: torch.Generator,
                     batch_shape: tuple[int, ...]) -> torch.Tensor:
        """The 8 conditioning noise fields at IO resolution,
        (*batch_shape, n_noise, H, W), from a stationary draw."""
        nbufs = self.noise_buffers()
        return self.noise.to_grid(
            self.noise.init_state(generator, batch_shape, nbufs), nbufs)
