"""Initial-condition perturbations for ensemble seeding (paper App. E).

Two ways to seed the members on top of the noise conditioning:

* **Observation-error sampling** -- Gaussian random fields with the
  climatological angular spectrum, scaled per channel by the
  climatological std, mimicking analysis uncertainty at t0.
* **Bred vectors** (Toth & Kalnay 1993) -- perturbations cycled through
  short model rollouts: perturb, integrate control and perturbed states,
  take the difference, rescale to a target amplitude, repeat, so the
  perturbations align with the fastest-growing directions of the flow.

Both are antithetically centered (paper E.3): members come in +/- pairs
whose mean is exactly the control analysis.  ``ForecastEngine.init_carry``
builds the perturbed members on the device.

The white spectral draws come from a source object, as the engine's noise
draws do: ``GeneratorDraws`` (a ``torch.Generator``) or ``InjectedDraws``
(given coefficients, so a test can replay the JAX reference's threefry
draws).  The module is data-agnostic: the spectral shape (``sigma_l``) and
the per-channel climatological std arrive as arrays; ``from_dataset``
wires them from the synthetic-ERA5 surrogate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Protocol

import torch

from repro_torch.core.sphere import noise as noiselib
from repro_torch.core.sphere import sht as shtlib
from repro_torch.evaluation import metrics

PERTURB_KINDS = ("none", "obs", "bred")


def validate_member_count(members: int, centered: bool,
                          cfg: "PerturbationConfig") -> list[str]:
    """Up-front member/perturbation compatibility check for CLIs.

    Returns human-readable problem strings (empty = valid), so a caller
    can raise a clear error before any model work starts instead of a
    failure mid-rollout or a silently off-center ensemble mean.
    """
    problems: list[str] = []
    if members < 1:
        problems.append(f"members must be >= 1, got {members}")
        return problems
    # members == 1 is the degenerate single-trajectory case: there is no
    # pair whose mean could be off-center, so nothing to validate.
    if members % 2 and members > 1:
        if centered:
            problems.append(
                f"antithetic noise centering needs an even member count "
                f"(members come in +/- pairs whose mean is the control); "
                f"got members={members}")
        elif cfg.active and cfg.antithetic:
            problems.append(
                f"antithetic initial-condition perturbations need an even "
                f"member count; got members={members}")
    draws = (members + 1) // 2 if cfg.antithetic else members
    if cfg.ensemble_transform and draws < 2:
        detail = (">= 4 antithetic members" if cfg.antithetic
                  else ">= 2 members")
        problems.append(
            "ensemble_transform needs at least two independent draws to "
            f"orthogonalize ({detail}); got members={members}")
    return problems


@dataclasses.dataclass(frozen=True)
class PerturbationConfig:
    """Initial-condition perturbation hyperparameters.

    kind:        "none" (replicate the analysis), "obs" (observation-error
                 sampling) or "bred" (cycled bred vectors).
    amplitude:   target perturbation size per channel, in units of the
                 sampler's ``channel_std`` (area-weighted RMS for bred
                 vectors; pointwise std for obs sampling).
    bred_cycles: breeding cycles (perturb -> integrate -> rescale).
    bred_steps:  model steps per breeding cycle.
    antithetic:  +/- pair centering (E.3); ceil(E/2) independent draws.
    ensemble_transform:
                 orthogonalize the bred draws against each other in the
                 area-weighted inner product after every cycle (Wei et al.
                 2008), so the pairs span K distinct growing directions
                 instead of collapsing onto the leading one.  Requires
                 kind="bred" and at least two independent draws.
    """

    kind: str = "none"
    amplitude: float = 0.05
    bred_cycles: int = 3
    bred_steps: int = 1
    antithetic: bool = True
    ensemble_transform: bool = False

    def __post_init__(self):
        if self.kind not in PERTURB_KINDS:
            raise ValueError(
                f"unknown perturbation kind {self.kind!r}; "
                f"expected one of {PERTURB_KINDS}")
        if self.kind == "bred" and self.bred_cycles < 1:
            raise ValueError("bred perturbations need bred_cycles >= 1")
        if self.ensemble_transform and self.kind != "bred":
            raise ValueError(
                "ensemble_transform orthogonalizes bred-vector pairs; it "
                f"requires kind='bred', got kind={self.kind!r}")

    @property
    def active(self) -> bool:
        """Whether members are perturbed at all."""
        return self.kind != "none"


class PerturbationDraws(Protocol):
    """Where the perturbations' white spectral coefficients come from."""

    def coeffs(self, batch_shape: tuple[int, ...], sigma_l: torch.Tensor,
               lmax: int, mmax: int) -> torch.Tensor:
        """(*batch_shape, L, M) complex64 coefficients scaled by sigma_l."""


class GeneratorDraws:
    """Draws from a ``torch.Generator``."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def coeffs(self, batch_shape, sigma_l, lmax, mmax):
        """Fresh coefficients from the generator."""
        return noiselib.sample_spectral_coeffs(self.generator, batch_shape,
                                               sigma_l, lmax, mmax)


class InjectedDraws:
    """Given coefficients, (*batch_shape, L, M) complex."""

    def __init__(self, coeffs):
        self._coeffs = coeffs

    def coeffs(self, batch_shape, sigma_l, lmax, mmax):
        """The injected coefficients, on ``sigma_l``'s device."""
        c = torch.as_tensor(self._coeffs).to(sigma_l.device)
        want = tuple(batch_shape) + (lmax, mmax)
        if tuple(c.shape) != want:
            raise ValueError(f"injected perturbation coefficients have shape "
                             f"{tuple(c.shape)}, the caller wants {want}")
        return c


class InitialConditionPerturbation:
    """Samples perturbed ensemble members around one analysis state.

    Args:
      sht:          IO-resolution SHT (shared with the noise process).
      cfg:          PerturbationConfig.
      area_weights: (H, W) quadrature weights for amplitude norms.
      sigma_l:      (L,) per-degree std of the perturbation spectrum;
                    defaults to the band-limited power law of the
                    synthetic-ERA5 surrogate.
      channel_std:  scalar or (C,) climatological per-channel std; the
                    amplitude is ``cfg.amplitude`` times this.
      device:       where the draws and fields live.
    """

    def __init__(self, sht: shtlib.SHT, cfg: PerturbationConfig,
                 area_weights, sigma_l=None, channel_std=1.0,
                 device: torch.device | str = "cpu"):
        self.sht = sht
        self.cfg = cfg
        self.device = torch.device(device)
        self.area_weights = torch.as_tensor(area_weights).float().to(
            self.device)
        if sigma_l is None:
            sigma_l = noiselib.power_law_sigma_l(sht.lmax)
        self.sigma_l = torch.as_tensor(sigma_l).float().to(self.device)
        self.channel_std = torch.as_tensor(channel_std).float().to(
            self.device)
        self._buffers: dict | None = None

    @property
    def buffers(self) -> dict:
        """The inverse-SHT table, built lazily: a caller that already holds
        it for the same SHT (the engine's noise buffers) passes its own via
        ``sht_buffers`` and this copy is never made."""
        if self._buffers is None:
            _, pbar = self.sht.tables()
            self._buffers = {"pct": torch.from_numpy(
                pbar.astype("float32")).to(self.device)}
        return self._buffers

    @classmethod
    def from_dataset(cls, sht: shtlib.SHT, cfg: PerturbationConfig, ds
                     ) -> "InitialConditionPerturbation":
        """Spectrum and climatological std from a SyntheticERA5-like
        dataset (``spectrum_sigma_l`` / ``channel_std`` / ``grid`` /
        ``dev``)."""
        return cls(sht, cfg, ds.grid.area_weights_2d(),
                   sigma_l=ds.spectrum_sigma_l, channel_std=ds.channel_std(),
                   device=ds.dev)

    # ------------------------------------------------------------------
    def _n_draws(self, members: int) -> int:
        return (members + 1) // 2 if self.cfg.antithetic else members

    def _channel_scale(self, n_channels: int) -> torch.Tensor:
        return self.cfg.amplitude * self.channel_std.expand((n_channels,))

    # ------------------------------------------------------------------
    def obs_vectors(self, draws: PerturbationDraws, n: int, n_channels: int,
                    sht_buffers: dict | None = None,
                    take: tuple[int, int] | None = None) -> torch.Tensor:
        """(n, C, H, W) independent obs-error fields: unit pointwise
        variance by the sigma_l normalization, scaled per channel to
        ``amplitude * channel_std``.  ``take`` = (lo, hi): all n draws
        are drawn, and only draws lo..hi-1 made into fields."""
        b = sht_buffers if sht_buffers is not None else self.buffers
        c = draws.coeffs((n, n_channels), self.sigma_l, self.sht.lmax,
                         self.sht.mmax)
        if take is not None:
            c = c[take[0]:take[1]]
        fields = shtlib.sht_inverse(c, b["pct"], self.sht.grid.nlon)
        return fields * self._channel_scale(n_channels)[:, None, None]

    def _rescale(self, p: torch.Tensor) -> torch.Tensor:
        """Rescale each channel to the target area-weighted RMS amplitude."""
        rms = torch.sqrt(metrics._spatial_mean(p * p, self.area_weights))
        target = self._channel_scale(p.shape[-3])
        return p * (target / rms.clamp_min(1e-12))[..., None, None]

    def orthogonalize(self, p: torch.Tensor) -> torch.Tensor:
        """Ensemble-transform whitening of the draw axis (Wei et al. 2008).

        ``p`` is (K, C, H, W); the draws are rotated and rescaled by
        ``(P Pt)^(-1/2)``, the symmetric inverse square root of their Gram
        matrix in the area-weighted inner product over (C, H, W), so they
        come out orthonormal.  The symmetric choice perturbs each draw
        least and does not depend on the eigenvectors' signs.
        """
        k = p.shape[0]
        if k < 2:
            return p
        w = self.area_weights / self.area_weights.sum()
        flat = (p * w.sqrt()).reshape(k, -1)
        gram = flat @ flat.T
        lam, u = torch.linalg.eigh(gram)
        inv_sqrt = (u / lam.clamp_min(1e-12).sqrt()) @ u.T
        return torch.einsum("ij,j...->i...", inv_sqrt, p)

    def bred_vectors(self, draws: PerturbationDraws, state0: torch.Tensor,
                     step_fn: Callable[[torch.Tensor], torch.Tensor], n: int,
                     sht_buffers: dict | None = None,
                     take: tuple[int, int] | None = None) -> torch.Tensor:
        """(n, C, H, W) bred vectors grown by cycled short rollouts.

        Seeded from obs-error draws rescaled to the target amplitude; each
        cycle integrates the control and the perturbed states
        ``bred_steps`` model steps, takes the difference (orthogonalized
        under ``ensemble_transform``) and rescales it per channel back to
        ``amplitude * channel_std``.  ``step_fn`` takes one state (C, H,
        W) or a batch (n, C, H, W).  ``take`` = (lo, hi) breeds draws
        lo..hi-1 only (each grows on its own without the ensemble
        transform, which mixes every draw and so needs all of them).
        """
        nc = state0.shape[-3]
        p = self._rescale(self.obs_vectors(draws, n, nc, sht_buffers, take))
        ctrl = state0
        for _ in range(self.cfg.bred_cycles):
            pert = ctrl + p
            for _ in range(self.cfg.bred_steps):
                ctrl = step_fn(ctrl)
                pert = step_fn(pert)
            d = pert - ctrl
            if self.cfg.ensemble_transform:
                d = self.orthogonalize(d)
            p = self._rescale(d)
        return p

    # ------------------------------------------------------------------
    def members(self, draws: PerturbationDraws, state0: torch.Tensor,
                members: int,
                step_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
                sht_buffers: dict | None = None,
                block: tuple[int, int] | None = None) -> torch.Tensor:
        """(E, C, H, W) perturbed members around ``state0``; "bred" needs
        ``step_fn`` (one step of the control dynamics).  With antithetic
        centering each +/- pair's mean is the control analysis.

        ``block`` = (lo, hi): members lo..hi-1 of the E only, as the
        whole ensemble holds them (a rank's block under the engine's
        ``member_axes``): every draw is drawn, only the draws those
        members take are made into fields (all of them for bred vectors
        under the ensemble transform)."""
        lo, hi = block if block is not None else (0, members)
        if not self.cfg.active:
            return state0.expand((hi - lo,) + tuple(state0.shape))
        k = self._n_draws(members)
        pair = 2 if self.cfg.antithetic else 1
        take = (lo // pair, (hi - 1) // pair + 1)
        if self.cfg.kind == "bred" and self.cfg.ensemble_transform:
            take = (0, k)
        if self.cfg.kind == "obs":
            p = self.obs_vectors(draws, k, state0.shape[-3], sht_buffers,
                                 take)
        else:
            if step_fn is None:
                raise ValueError(
                    "bred perturbations need a step_fn (model dynamics)")
            p = self.bred_vectors(draws, state0, step_fn, k, sht_buffers,
                                  take)
        if not self.cfg.antithetic:
            return state0 + p[lo - take[0]:hi - take[0]]
        # member j is +/- draw j // 2 (the sign of its slot's parity), as
        # antithetic_expand places it (a trailing unpaired member gets +)
        j = torch.arange(lo, hi)
        sign = (1.0 - 2.0 * (j % 2)).to(p.device, p.dtype)
        return state0 + p.index_select(0, (j // 2 - take[0]).to(p.device)) \
            * sign.reshape(-1, 1, 1, 1)
