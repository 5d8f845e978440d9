"""Ensemble forecast engine: the autoregressive FCN3 rollout with in-loop
scoring (paper Section 5 / Appendix G.4).

Per lead: AR(1) spherical noise to the grid (inverse SHT), antithetic
centering, one FCN3 step over all members at once (the members are the
leading batch dim, where the JAX engine ``vmap``s), the noise transition,
and fair CRPS / ensemble-mean RMSE / spread / spread-skill ratio / rank
histogram against the verifying state.  Raw member fields never leave the
device.  The rollout is a plain loop under ``torch.inference_mode``; it
yields one ``ForecastResult`` per ``lead_chunk`` leads.

Noise draws come from a ``NoiseSource``: ``GeneratorNoise`` (a
``torch.Generator``, the default) or ``InjectedNoise`` (given draws, so a
test can replay the JAX reference's threefry stream).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Protocol

import numpy as np
import torch

from repro_torch.core.fcn3 import FCN3
from repro_torch.core.sphere import noise as noiselib
from repro_torch.evaluation import metrics

#: score names an engine forecast emits, in emission order.
SCORE_NAMES = ("crps", "ens_rmse", "spread", "ssr", "rank_hist")


def in_scan_rank_histogram(ens: torch.Tensor, target: torch.Tensor,
                           area_weights: torch.Tensor) -> torch.Tensor:
    """(C, E+1) area-weighted rank histogram.

    Ranks are comparison counts, binned by one ``torch.bincount`` over
    (channel, latitude ring, rank) segments -- O(E) memory per grid point
    and no (H, W, E+1) one-hot -- then contracted with the ring weights
    exactly as ``metrics.rank_histogram_per_channel``.
    """
    e = ens.shape[0]
    rank = (ens < target[None]).sum(dim=0)                     # (C, H, W)
    c, h, _ = rank.shape
    seg = rank + (e + 1) * torch.arange(
        c * h, device=rank.device).reshape(c, h, 1)
    counts = torch.bincount(seg.reshape(-1), minlength=c * h * (e + 1))
    return metrics.ring_contract(counts.reshape(c, h, e + 1), area_weights)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """members: ensemble size E (antithetic pairs when ``centered``);
    lead_chunk: leads per yielded result block; centered: antithetic
    noise centering (paper E.3)."""

    members: int = 4
    lead_chunk: int = 8
    centered: bool = True

    def __post_init__(self):
        if self.members < 1:
            raise ValueError(f"members must be >= 1, got {self.members}")
        if self.lead_chunk < 1:
            raise ValueError(
                f"lead_chunk must be >= 1, got {self.lead_chunk}")


@dataclasses.dataclass
class ForecastResult:
    """Scores for a contiguous block of lead times.

    lead_steps: (T,) 0-based lead indices; lead i verifies at t0 + 6h*(i+1).
    scores: per-channel (T, C) "crps"/"ens_rmse"/"spread"/"ssr" and the
      (T, C, E+1) "rank_hist" when truth is given; empty otherwise.
    final_state / final_noise: the ensemble carry after the last lead of
      the rollout (set on the final block only).
    """

    lead_steps: np.ndarray
    scores: dict[str, torch.Tensor]
    final_state: torch.Tensor | None = None
    final_noise: torch.Tensor | None = None


def _concat_results(parts: list[ForecastResult]) -> ForecastResult:
    return ForecastResult(
        lead_steps=np.concatenate([p.lead_steps for p in parts]),
        scores={k: torch.cat([p.scores[k] for p in parts])
                for k in parts[0].scores},
        final_state=parts[-1].final_state,
        final_noise=parts[-1].final_noise)


class NoiseSource(Protocol):
    """Where the noise process's white draws come from (the engine's
    rollout and the trainer's both read them)."""

    def initial(self, model: FCN3, batch_shape: tuple[int, ...],
                buffers: dict) -> torch.Tensor:
        """z_hat at lead 0: (*batch_shape, n_proc, L, M) complex64."""

    def eta(self, model: FCN3, n: int, z_hat: torch.Tensor, buffers: dict
            ) -> torch.Tensor:
        """The white draw of the AR(1) update after lead ``n``."""


class GeneratorNoise:
    """Draws from a ``torch.Generator`` (on the model's device)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def initial(self, model, batch_shape, buffers):
        """Initial noise state drawn from the generator."""
        return model.noise.init_state(self.generator, batch_shape, buffers)

    def eta(self, model, n, z_hat, buffers):
        """White spectral draws for lead ``n``."""
        return model.noise.sample_coeffs(self.generator, z_hat.shape[:-3],
                                         buffers)


class InjectedNoise:
    """Given draws: ``z_hat0`` (*batch, n_proc, L, M) and ``etas[n]`` per
    lead."""

    def __init__(self, z_hat0, etas):
        self.z_hat0 = z_hat0
        self.etas = etas

    def initial(self, model, batch_shape, buffers):
        """The injected initial noise state."""
        z = torch.as_tensor(self.z_hat0).to(model.device)
        if tuple(z.shape[:-3]) != tuple(batch_shape):
            raise ValueError(f"injected z_hat0 has batch {tuple(z.shape[:-3])}"
                             f", the caller wants {tuple(batch_shape)}")
        return z

    def eta(self, model, n, z_hat, buffers):
        """The injected white draws of lead ``n``."""
        return torch.as_tensor(self.etas[n]).to(z_hat.device)


class ForecastEngine:
    """Autoregressive ensemble forecaster for an FCN3 model.

        eng = ForecastEngine(model, EngineConfig(members=8))
        res = eng.forecast(buffers, state0, aux, noise, truth=truth)
        res.scores["crps"]          # (T, C) fair CRPS per lead/channel

    ``aux``/``truth`` are stacked (T, ., H, W) tensors or
    ``fn(step) -> (., H, W)`` callables (then ``steps=`` is required).
    """

    def __init__(self, model: FCN3, cfg: EngineConfig):
        self.model = model
        self.cfg = cfg
        self.noise_buffers = model.noise_buffers()
        self.area_weights = torch.from_numpy(
            model.grid_in.area_weights_2d().astype(np.float32)).to(
                model.device)

    def init_carry(self, state0: torch.Tensor, noise: NoiseSource
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """(E, C, H, W) replicated state and the lead-0 noise coefficients."""
        e = self.cfg.members
        s = state0.to(self.model.device).float().expand(
            (e,) + tuple(state0.shape)).contiguous()
        return s, noise.initial(self.model, (e,), self.noise_buffers)

    def noise_fields(self, z_hat: torch.Tensor) -> torch.Tensor:
        """Grid-space conditioning noise as the step sees it."""
        z = self.model.noise.to_grid(z_hat, self.noise_buffers)
        return noiselib.center_noise(z, 0) if self.cfg.centered else z

    def scores(self, sf: torch.Tensor, truth: torch.Tensor
               ) -> dict[str, torch.Tensor]:
        """The five in-loop scores of one lead, each per channel."""
        aw = self.area_weights
        return {
            "crps": metrics.crps(sf, truth, aw),
            "ens_rmse": metrics.ensemble_skill(sf, truth, aw),
            "spread": metrics.ensemble_spread(sf, aw),
            "ssr": metrics.spread_skill_ratio(sf, truth, aw),
            "rank_hist": in_scan_rank_histogram(sf, truth, aw),
        }

    def step(self, buffers: dict, s: torch.Tensor, z_hat: torch.Tensor,
             aux: torch.Tensor, eta: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """One lead: conditioned model step, then the noise transition."""
        e = self.cfg.members
        cond = torch.cat([aux.expand((e,) + tuple(aux.shape)),
                          self.noise_fields(z_hat)], dim=1)
        s = self.model(buffers, s, cond)
        return s, self.model.noise.step_with(z_hat, eta)

    @staticmethod
    def _at(src, n: int, device) -> torch.Tensor:
        val = src(n) if callable(src) else src[n]
        return torch.as_tensor(val).to(device).float()

    def stream(self, buffers: dict, state0: torch.Tensor, aux,
               noise: NoiseSource, steps: int | None = None, truth=None
               ) -> Iterator[ForecastResult]:
        """Roll the forecast, yielding one ForecastResult per lead chunk."""
        if steps is None:
            if callable(aux):
                raise ValueError("steps= is required when aux is a callable")
            steps = len(aux)
        if steps < 1:
            raise ValueError(f"need at least one lead step, got {steps}")
        dev = self.model.device
        # inference mode is entered per chunk, never held across a yield
        # (it is thread-local state the caller's code would inherit)
        with torch.inference_mode():
            s, z_hat = self.init_carry(state0, noise)
        for start in range(0, steps, self.cfg.lead_chunk):
            stop = min(steps, start + self.cfg.lead_chunk)
            with torch.inference_mode():
                per_lead: list[dict] = []
                for n in range(start, stop):
                    eta = noise.eta(self.model, n, z_hat,
                                    self.noise_buffers)
                    s, z_hat = self.step(buffers, s, z_hat,
                                         self._at(aux, n, dev), eta)
                    if truth is not None:
                        per_lead.append(self.scores(
                            s, self._at(truth, n, dev)))
                scores = ({k: torch.stack([d[k] for d in per_lead])
                           for k in SCORE_NAMES} if per_lead else {})
            last = stop == steps
            yield ForecastResult(
                lead_steps=np.arange(start, stop), scores=scores,
                final_state=s if last else None,
                final_noise=z_hat if last else None)

    def forecast(self, buffers: dict, state0: torch.Tensor, aux,
                 noise: NoiseSource, steps: int | None = None, truth=None
                 ) -> ForecastResult:
        """Run the whole rollout and concatenate the per-chunk results."""
        return _concat_results(list(self.stream(
            buffers, state0, aux, noise, steps=steps, truth=truth)))


def members_noise(model: FCN3, seed: int) -> GeneratorNoise:
    """The default noise source: a generator on the model's device."""
    g = torch.Generator(device=model.device)
    g.manual_seed(seed)
    return GeneratorNoise(g)

