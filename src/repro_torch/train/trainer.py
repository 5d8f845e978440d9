"""End-to-end ensemble training for FCN3 (paper Section 4 / Appendix E).

The paper's training semantics, as in the JAX package:

* ensemble members share parameters and the input state; they differ
  only in the latent diffusion noise (hidden Markov model);
* the noise evolves between autoregressive steps by the spherical AR(1)
  diffusion (B.7) and may be antithetically centered (E.3);
* the composite nodal + spectral CRPS objective (48) is evaluated per
  rollout step with lead-time weights w_n and channel weights
  w_c * w_{dt,c}, through the fused CRPS kernel;
* stages (Table 3) switch rollout length, ensemble size, fair-vs-biased
  CRPS and the LR schedule.

Members are the leading batch dim of one model call (the JAX trainer
``vmap``s them).  Noise draws come from a ``NoiseSource`` of the engine,
so a test can replay the JAX reference's draws.  Ensemble-parallel
sharding (the JAX ``member_axes``) belongs to the distributed port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import crps as crpslib
from repro_torch.core.fcn3 import FCN3
from repro_torch.core.sphere import noise as noiselib
from repro_torch.inference.engine import NoiseSource
from repro_torch.optim import adam as adamlib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One training stage's knobs (the JAX ``TrainConfig`` without
    ``member_axes``)."""

    ensemble_size: int = 2
    rollout_steps: int = 1
    fair_crps: bool = False
    lambda_spectral: float = 1.0
    noise_centering: bool = False
    lr: float = 5e-4
    lr_halve_every: int | None = None
    clip_norm: float | None = 1.0
    rollout_weights: tuple[float, ...] | None = None  # default: uniform


def make_optimizer(cfg: TrainConfig) -> adamlib.Adam:
    """Adam at the stage's rate, halved every ``lr_halve_every`` steps."""
    lr = (adamlib.halving_schedule(cfg.lr, cfg.lr_halve_every)
          if cfg.lr_halve_every else cfg.lr)
    return adamlib.Adam(lr=lr, clip_norm=cfg.clip_norm)


class EnsembleTrainer:
    """Train and eval steps for an FCN3 model; makes its parameters
    trainable."""

    def __init__(self, model: FCN3, tcfg: TrainConfig,
                 channel_weights: np.ndarray):
        self.model = model.requires_grad_(True)
        self.tcfg = tcfg
        self.optimizer = make_optimizer(tcfg)
        dev = model.device
        self.channel_weights = torch.as_tensor(
            np.asarray(channel_weights, np.float32)).to(dev)
        self.area_weights = torch.from_numpy(
            model.grid_in.area_weights_2d().astype(np.float32)).to(dev)

    def make_loss_buffers(self) -> dict:
        """The loss's forward-SHT table at IO resolution (1.5 GB at
        721x1440) and the noise process's tables."""
        wpct, _ = self.model.in_sht.tables()
        return {
            "loss_wpct": torch.from_numpy(wpct.astype(np.float32)).to(
                self.model.device),
            "noise": self.model.noise_buffers(),
        }

    # ------------------------------------------------------------------
    def rollout_loss(self, buffers: dict, batch: dict, noise: NoiseSource
                     ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """batch: state (B,C,H,W); targets (B,T,C,H,W); aux (B,T,A,H,W).

        Returns the w_n-weighted objective over the T rollout steps and
        the per-step ``nodal_{n}`` / ``spectral_{n}`` terms.
        """
        m, t = self.model, self.tcfg
        e = t.ensemble_size
        steps = batch["targets"].shape[1]
        w_n = (np.asarray(t.rollout_weights, np.float32)
               if t.rollout_weights else np.ones((steps,), np.float32))
        w_n = w_n / w_n.sum()
        nbufs = buffers["noise"]
        state = batch["state"]
        z_hat = noise.initial(m, (e,) + tuple(state.shape[:1]), nbufs)
        s = state.expand((e,) + tuple(state.shape))
        total = torch.zeros((), dtype=torch.float32, device=state.device)
        aux_out: dict[str, torch.Tensor] = {}
        for n in range(steps):
            z = m.noise.to_grid(z_hat, nbufs)          # (E,B,8,H,W)
            if t.noise_centering:
                z = noiselib.center_noise(z, 0)
            aux_n = batch["aux"][:, n]                  # (B,A,H,W)
            cond = torch.cat([aux_n.expand((e,) + tuple(aux_n.shape)), z],
                             dim=2)
            s = m(buffers, s, cond)
            loss_n, aux = crpslib.fcn3_objective(
                s, batch["targets"][:, n], self.area_weights,
                buffers["loss_wpct"], self.channel_weights,
                t.lambda_spectral, t.fair_crps)
            total = total + float(w_n[n]) * loss_n
            aux_out = {f"nodal_{n}": aux["nodal"],
                       f"spectral_{n}": aux["spectral"], **aux_out}
            if n + 1 < steps:
                z_hat = m.noise.step_with(z_hat,
                                          noise.eta(m, n, z_hat, nbufs))
        return total, aux_out

    def loss_and_grads(self, buffers: dict, batch: dict, noise: NoiseSource
                       ) -> tuple[torch.Tensor, dict, dict[str, torch.Tensor]]:
        """The rollout loss, its terms and its gradient per parameter."""
        params = dict(self.model.named_parameters())
        loss, aux = self.rollout_loss(buffers, batch, noise)
        grads = torch.autograd.grad(loss, list(params.values()))
        return (loss.detach(), {k: v.detach() for k, v in aux.items()},
                dict(zip(params, grads)))

    def train_step(self, buffers: dict, opt_state: dict, batch: dict,
                   noise: NoiseSource) -> tuple[dict, dict]:
        """One optimizer step; the parameters are updated in place.

        Returns the new optimizer state and the diagnostics: the loss
        terms, ``loss`` and ``grad_norm`` (before clipping).
        """
        loss, aux, grads = self.loss_and_grads(buffers, batch, noise)
        gnorm = adamlib.global_norm(grads)
        opt_state = self.optimizer.update(
            dict(self.model.named_parameters()), grads, opt_state)
        return opt_state, dict(aux, loss=loss, grad_norm=gnorm)

    @torch.no_grad()
    def eval_step(self, buffers: dict, batch: dict, noise: NoiseSource,
                  n_members: int = 4) -> dict[str, torch.Tensor]:
        """One-step fair CRPS and ensemble-mean RMSE of ``n_members``."""
        m = self.model
        nbufs = buffers["noise"]
        state = batch["state"]
        z_hat = noise.initial(m, (n_members,) + tuple(state.shape[:1]),
                              nbufs)
        z = m.noise.to_grid(z_hat, nbufs)
        aux_n = batch["aux"][:, 0]
        cond = torch.cat(
            [aux_n.expand((n_members,) + tuple(aux_n.shape)), z], dim=2)
        pred = m(buffers, state.expand((n_members,) + tuple(state.shape)),
                 cond)
        tgt = batch["targets"][:, 0]
        nodal = crpslib.nodal_crps_loss(pred, tgt, self.area_weights,
                                        fair=True)
        rmse_em = torch.sqrt(torch.einsum(
            "bchw,hw->bc", (pred.mean(dim=0) - tgt) ** 2, self.area_weights))
        return {"crps": nodal.mean(), "rmse_ens_mean": rmse_em.mean()}


def estimate_wdt(samples: torch.Tensor) -> np.ndarray:
    """Temporal channel weights w_{dt,c}, paper eq. (49).

    samples: (N, T, C, H, W) consecutive states; weight = 1 / std of the
    one-step differences, per channel (population std).
    """
    diff = samples[:, 1:] - samples[:, :-1]
    std = diff.float().std(dim=(0, 1, 3, 4), correction=0).cpu().numpy()
    return 1.0 / np.maximum(std, 1e-6)
