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
so a test can replay the JAX reference's draws.

Ensemble parallelism (paper G.1, the JAX ``member_axes``): with
``TrainConfig.member_axes = (ens_axis, data_axis)`` and a ``DeviceMesh``,
each rank of the ensemble group rolls out its E/R members on its slice
of the data group's batch.  Every rank draws the whole (E, B) noise from
the same ``NoiseSource`` and keeps its members, so the draws match a
single process's.  Eq. (48) is computed with ``dist_crps`` (Algorithm 3)
on two flattened spaces, C*H*W and C*L*M, whose per-point weights fold in
everything linear: area weight x channel weight / B for the nodal term,
mode mask x multiplicity / dof x the channel weight / B for the spectral
one.  Gradients are summed over the ensemble group and averaged over the
data group.  The parameters are placed as ``sharding.fcn3_param_specs(
mode="domain")`` says: replicated, broadcast from rank 0 at construction,
so they and the Adam state stay identical on every rank.  Noise
centering gathers every member's noise with a ``psum`` over the ensemble
group.

Domain decomposition (paper G.2, the JAX ``mode="domain"``): with a
``DeviceMesh`` and no ``member_axes``, the mesh's model axis carries
latitude.  Every rank rolls out all E members on its row block of the
fields (``distributed.domain.DomainFCN3``), draws the whole (E, B) noise
from the same ``NoiseSource`` and projects it onto its rows, and scores
its points:
the nodal term on its C x H_loc x W points with its rows' area weights,
the spectral term on its block of degrees from Algorithm 1 at the IO
grid, each through ``dist_crps`` on a group of itself (the CRPS kernel
forward and backward) and summed over the latitude group.  Gradients
are summed over the latitude group and averaged over the data group.
``eval_step`` (the JAX ``make_eval_step``) runs the same way on the
rank's rows: the nodal CRPS through ``dist_crps``, the ensemble-mean
RMSE's squared errors summed over the latitude group before the square
root.

Channel parallelism (the JAX ``mode="channel"``): with a ``DeviceMesh``
and ``placement="channel"``, the model axis carries the latent channels
(``distributed.channel``): the parameters that the sanitized
``fcn3_param_specs(mode="channel")`` splits are replaced by this rank's
blocks, every rank rolls out all E members on its slice of the data
group's batch and scores them as one process does, and every gradient
(a split leaf's block, or a replicated leaf's whole gradient, equal on
every model rank) is averaged over the data group only; Adam runs on the
local blocks, and the clipping's global norm sums the split leaves'
squares over the model group.  The same holds, with nothing split, for
ensemble parallelism whose ensemble the model axis does not divide: the
member axis is replicated over the model ranks (as the reference's
``sanitize_specs`` drops the entry), so every model rank runs every
member.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import crps as crpslib
from repro_torch.core.fcn3 import FCN3
from repro_torch.core.sphere import noise as noiselib
from repro_torch.core.sphere import sht as shtlib
from repro_torch.distributed import channel, compat, domain, sharding
from repro_torch.inference.engine import NoiseSource
from repro_torch.optim import adam as adamlib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One training stage's knobs (the JAX ``TrainConfig``)."""

    ensemble_size: int = 2
    rollout_steps: int = 1
    fair_crps: bool = False
    lambda_spectral: float = 1.0
    noise_centering: bool = False
    lr: float = 5e-4
    lr_halve_every: int | None = None
    clip_norm: float | None = 1.0
    rollout_weights: tuple[float, ...] | None = None  # default: uniform
    # Ensemble parallelism (paper G.1): the mesh axes of the (E, B)
    # leading dims of the member states, e.g. ("model", "data"); each
    # entry a mesh-axis name or None.  None: one process, or with a mesh
    # the domain decomposition over DOMAIN_AXES.
    member_axes: tuple | None = None


#: the mesh axes of the domain decomposition: latitude, then the batch
DOMAIN_AXES = (sharding.MP, sharding.DP)


def domain_axes(mesh) -> tuple:
    """The domain decomposition's axes on ``mesh``: latitude over the
    model axis, the batch over every other axis taken together
    (``DOMAIN_AXES`` on a ``("data", "model")`` mesh)."""
    rest = tuple(a for a in mesh.mesh_dim_names if a != sharding.MP)
    return (sharding.MP, rest[0] if len(rest) == 1 else rest)


def make_optimizer(cfg: TrainConfig) -> adamlib.Adam:
    """Adam at the stage's rate, halved every ``lr_halve_every`` steps."""
    lr = (adamlib.halving_schedule(cfg.lr, cfg.lr_halve_every)
          if cfg.lr_halve_every else cfg.lr)
    return adamlib.Adam(lr=lr, clip_norm=cfg.clip_norm)


@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """The groups of a trainer's two mesh axes: the model group (the
    ensemble with ``member_axes``, latitude in the domain decomposition;
    its size and this rank's index) and the data group."""

    model_group: object
    n_model: int
    model_rank: int
    data_group: object | None
    n_data: int
    data_rank: int

    @classmethod
    def of(cls, axes: tuple, mesh) -> "MeshGroups":
        """The groups of ``axes`` = (model_axis[, data_axis]) on ``mesh``,
        which they must cover: the gradient sum runs over the whole
        world.  The data axis may be a tuple of axes taken together (the
        ``("pod", "data")`` of a multi-pod mesh)."""
        import torch.distributed as dist
        model_axis, data_axis = (tuple(axes) + (None,))[:2]
        if mesh is None or not isinstance(model_axis, str):
            raise ValueError(f"mesh axes {axes} need a mesh and a model "
                             "axis name")
        groups = {}
        for axis in (model_axis, data_axis):
            if axis is not None:
                g = compat.mesh_group(
                    mesh, axis if isinstance(axis, tuple) else (axis,))
                groups[axis] = (g, dist.get_world_size(g), dist.get_rank(g))
        dg, nd, dr = groups.get(data_axis, (None, 1, 0))
        mg, nm, mr = groups[model_axis]
        if nm * nd != dist.get_world_size():
            raise ValueError(f"mesh axes {axes} cover {nm * nd} of "
                             f"{dist.get_world_size()} ranks; they must "
                             "cover the world")
        return cls(mg, nm, mr, dg, nd, dr)


def _flat_padded(x: torch.Tensor, lead: int, n: int) -> torch.Tensor:
    """``x`` with its dims after the first ``lead`` flattened and
    zero-padded to a multiple of ``n`` (zero points carry zero weight)."""
    x = x.reshape(tuple(x.shape[:lead]) + (-1,))
    pad = -x.shape[-1] % n
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


class EnsembleTrainer:
    """Train and eval steps for an FCN3 model; makes its parameters
    trainable.  With ``tcfg.member_axes``, ``mesh`` is the
    ``DeviceMesh`` those axes name (ensemble parallelism); with a
    ``mesh`` alone, the domain decomposition over its ``DOMAIN_AXES``
    (``self.domain``), or with ``placement="channel"`` the latent
    channels over its model axis (``self.channel``); construction is then
    collective.  On a mesh rank 0's parameters are broadcast here, and in
    channel mode each rank keeps its blocks of the split ones."""

    def __init__(self, model: FCN3, tcfg: TrainConfig,
                 channel_weights: np.ndarray, mesh=None,
                 placement: str = "domain"):
        self.model = model.requires_grad_(True)
        self.tcfg = tcfg
        self.optimizer = make_optimizer(tcfg)
        dev = model.device
        self.channel_weights = torch.as_tensor(
            np.asarray(channel_weights, np.float32)).to(dev)
        self.area_weights = torch.from_numpy(
            model.grid_in.area_weights_2d().astype(np.float32)).to(dev)
        self.par = self.domain = self.channel = None
        self.mesh = mesh
        # every model rank runs every member (channel mode, or an
        # ensemble the model axis does not divide)
        self.whole_members = False
        self.fwd = model
        if placement == "channel" and (mesh is None
                                       or tcfg.member_axes is not None):
            raise ValueError("channel placement needs a mesh and no "
                             "member_axes: the members stay whole")
        if tcfg.member_axes is not None or mesh is not None:
            self.par = MeshGroups.of(tcfg.member_axes or domain_axes(mesh),
                                     mesh)
            # rank 0's parameters, broadcast whole: the placement
            # (fcn3_param_specs) replicates every leaf but the channel
            # mode's split ones, of which each rank then keeps its block
            params = dict(model.named_parameters())
            compat.broadcast_([p.detach() for p in params.values()], 0)
            if placement == "channel":
                self.channel = channel.ChannelFCN3(
                    model, mesh, channel.channel_specs(model, mesh))
                self.fwd, self.whole_members = self.channel, True
            elif tcfg.member_axes is None:
                self.domain = domain.DomainFCN3(model, self.par.model_group)
                self.fwd = self.domain
            elif tcfg.ensemble_size % self.par.n_model:
                self.whole_members = True

    @property
    def split(self) -> set[str]:
        """The names of the parameters held as this rank's blocks."""
        return self.channel.split if self.channel is not None else set()

    def whole_state(self, opt_state: dict | None = None
                    ) -> tuple[dict, dict | None]:
        """The parameters and ``opt_state`` with every split leaf (its
        Adam moments too) gathered whole from the model ranks' blocks:
        what one process would hold, for a checkpoint.  Collective in
        channel mode; the model's own tensors otherwise."""
        params = {k: p.detach() for k, p in self.model.named_parameters()}
        if not self.split:
            return params, opt_state
        specs = self.channel.specs
        params = sharding.gather_blocks(params, specs, self.mesh)
        if opt_state is not None:
            opt_state = dict(opt_state, **{
                k: sharding.gather_blocks(opt_state[k], specs, self.mesh)
                for k in ("mu", "nu")})
        return params, opt_state

    def grad_norm(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole parameter set's gradients (a split
        leaf's blocks summed over the model group)."""
        if not self.split:
            return adamlib.global_norm(grads)
        return channel.split_norm(grads, self.split, self.par.model_group)

    def make_loss_buffers(self) -> dict:
        """The loss's forward-SHT table at IO resolution (1.5 GB at
        721x1440) and the noise process's tables; in the domain
        decomposition ``loss_sht``, the table's ``domain_sht_tables``,
        and the noise's inverse-SHT table on this rank's rows only."""
        m = self.model
        if self.domain is not None:
            return {"loss_sht": domain.domain_sht_tables(
                        m.in_sht, self.domain.io_blocks, m.device),
                    "noise": m.noise.buffers(m.device,
                                             self.domain.io_block)}
        wpct, _ = m.in_sht.tables()
        return {
            "loss_wpct": torch.from_numpy(wpct.astype(np.float32)).to(
                m.device),
            "noise": m.noise_buffers(),
        }

    def loss_buffer_specs(self) -> dict:
        """``make_loss_buffers``' keys, shapes and dtypes as ``meta``
        tensors (the JAX ``loss_buffer_specs``)."""
        m = self.model
        specs = m.in_sht.buffer_specs()
        sigma_l = torch.empty((m.noise.n_proc, m.in_sht.lmax),
                              dtype=torch.float32, device="meta")
        return {"loss_wpct": specs["wpct"],
                "noise": {"pct": specs["pct"], "sigma_l": sigma_l}}

    # ------------------------------------------------------------------
    def _members(self, z: torch.Tensor) -> torch.Tensor:
        """This rank's block of (E, B_global, ...) member tensors: its
        members (all of them in the domain decomposition) on its slice of
        the data group's batch."""
        p = self.par
        b = z.shape[1] // p.n_data
        z = z[:, p.data_rank * b:(p.data_rank + 1) * b]
        if self.domain is not None or self.whole_members:
            return z
        e = self.tcfg.ensemble_size // p.n_model
        return z[p.model_rank * e:(p.model_rank + 1) * e]

    def _centered(self, z: torch.Tensor) -> torch.Tensor:
        """``center_noise`` over all E members of this rank's block:
        every member gathered with a psum over the ensemble group."""
        p = self.par
        e_loc = z.shape[0]
        full = z.new_zeros((self.tcfg.ensemble_size,) + tuple(z.shape[1:]))
        full[p.model_rank * e_loc:(p.model_rank + 1) * e_loc] = z
        full = compat.psum(full, p.model_group)
        return noiselib.center_noise(full, 0)[p.model_rank * e_loc:
                                             (p.model_rank + 1) * e_loc]

    def _mesh_objective(self, ens: torch.Tensor, obs: torch.Tensor,
                        buffers: dict
                        ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Eq. (48) through ``dist_crps``: ``fcn3_objective``'s value for
        the data group's batch, on every rank of the model group.

        Ensemble parallelism: this rank's members (Eloc, B, C, H, W)
        against the batch's truth (B, C, H, W); both terms' points,
        zero-padded to a multiple of the ranks, scored over the ensemble
        group.  Domain decomposition: all members on this rank's rows
        (E, B, C, H_loc, W) against the truth there; the nodal term on
        its points with its rows' area weights, the spectral term on its
        block of degrees (Algorithm 1 at the IO grid, ``loss_sht``), each
        scored on a group of this rank alone, then summed over the
        latitude group."""
        from repro_torch.distributed.dist_crps import dist_crps
        t, d, sht = self.tcfg, self.domain, self.model.in_sht
        w_lm = torch.from_numpy(crpslib.spectral_weights(
            sht.lmax, sht.mmax).astype(np.float32)).to(ens.device)
        if d is None:
            g, n, area = self.par.model_group, self.par.n_model, \
                self.area_weights
            ce = shtlib.sht_forward(ens, buffers["loss_wpct"])
            co = shtlib.sht_forward(obs, buffers["loss_wpct"])
        else:
            g, n, area = d.solo, 1, self.area_weights[slice(*d.io_block)]
            # the members and the truth through one transform,
            # (E+1, B, C, Lloc, M)
            c = domain.domain_sht_forward(torch.cat([ens, obs[None]]),
                                          buffers["loss_sht"], d.group,
                                          d.solo, self.model.cfg.kernels)
            ce, co = c[:-1], c[-1]
            w_lm = domain.degree_block(w_lm.T, c.shape[-2], d.group).T
        cw = self.channel_weights / self.channel_weights.sum()
        b = obs.shape[0]
        blocks = self.model.cfg.kernels.blocks_for("crps")

        def score(e, o, w):
            # per-point weight: channel weight x the term's weight / B
            w = (cw[:, None, None] * w[None]) / b
            return dist_crps(_flat_padded(e, 2, n), _flat_padded(o, 1, n),
                             _flat_padded(w, 0, n), g, t.fair_crps, blocks)
        nodal = score(ens, obs, area)
        spec = sum(score(part(ce), part(co), w_lm)
                   for part in (torch.real, torch.imag))
        if d is not None:
            nodal, spec = compat.psum(torch.stack([nodal, spec]), d.group)
        return nodal + t.lambda_spectral * spec, {"nodal": nodal,
                                                  "spectral": spec}

    def rollout_loss(self, buffers: dict, batch: dict, noise: NoiseSource
                     ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """batch: state (B,C,H,W); targets (B,T,C,H,W); aux (B,T,A,H,W).

        Returns the w_n-weighted objective over the T rollout steps and
        the per-step ``nodal_{n}`` / ``spectral_{n}`` terms.  On a mesh
        ``batch`` is this rank's slice of the data group's batch (in the
        domain decomposition, on this rank's rows), and the values are
        those of the data group's batch.
        """
        m, t, p, d = self.model, self.tcfg, self.par, self.domain
        e = t.ensemble_size
        steps = batch["targets"].shape[1]
        w_n = (np.asarray(t.rollout_weights, np.float32)
               if t.rollout_weights else np.ones((steps,), np.float32))
        w_n = w_n / w_n.sum()
        nbufs = buffers["noise"]
        state = batch["state"]
        b_all = state.shape[0] * (p.n_data if p else 1)
        z_hat = noise.initial(m, (e, b_all), nbufs)
        # this rank's members: its block of them in ensemble parallelism
        spread = p is not None and d is None and not self.whole_members
        e_loc = e // p.n_model if spread else e
        s = state.expand((e_loc,) + tuple(state.shape))
        total = torch.zeros((), dtype=torch.float32, device=state.device)
        aux_out: dict[str, torch.Tensor] = {}
        for n in range(steps):
            # (E, B, 8, H, W); on this rank's rows in the domain
            # decomposition (its noise table holds those rows only)
            z = m.noise.to_grid(self._members(z_hat) if p else z_hat,
                                nbufs)
            if t.noise_centering:
                z = (self._centered(z) if spread
                     else noiselib.center_noise(z, 0))
            aux_n = batch["aux"][:, n]                  # (B,A,H,W)
            cond = torch.cat([aux_n.expand((e_loc,) + tuple(aux_n.shape)),
                              z], dim=2)
            s = self.fwd(buffers, s, cond)
            if p and not self.whole_members:
                loss_n, aux = self._mesh_objective(
                    s, batch["targets"][:, n], buffers)
            else:
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
        with telemetry.span("trainer.forward"):
            loss, aux = self.rollout_loss(buffers, batch, noise)
        # the recomputation, the band transpose and the CRPS backward
        with telemetry.span("trainer.backward"):
            grads = torch.autograd.grad(loss, list(params.values()))
        aux = {k: v.detach() for k, v in aux.items()}
        loss = loss.detach()
        p = self.par
        if p is not None:
            if self.whole_members:
                # every model rank holds the whole gradient of a
                # replicated leaf and its block's of a split one: the
                # mean over the data group
                if p.data_group is not None:
                    compat.all_reduce_(list(grads), p.data_group)
            else:
                # sum over the model group (the ensemble or latitude),
                # mean over the data group: one all-reduce over the
                # world, which the two groups cover
                compat.all_reduce_(list(grads), None)
            grads = [g / p.n_data for g in grads]
            if p.data_group is not None:
                diag = torch.stack([loss, *aux.values()])
                diag = compat.psum(diag, p.data_group) / p.n_data
                loss, aux = diag[0], dict(zip(aux, diag[1:]))
        return loss, aux, dict(zip(params, grads))

    def train_step(self, buffers: dict, opt_state: dict, batch: dict,
                   noise: NoiseSource) -> tuple[dict, dict]:
        """One optimizer step; the parameters are updated in place.

        Returns the new optimizer state and the diagnostics: the loss
        terms, ``loss`` and ``grad_norm`` (before clipping).
        """
        with telemetry.span("trainer.step"):
            loss, aux, grads = self.loss_and_grads(buffers, batch, noise)
            with telemetry.span("trainer.adam"):
                gnorm = self.grad_norm(grads)
                opt_state = self.optimizer.update(
                    dict(self.model.named_parameters()), grads, opt_state,
                    norm=gnorm)
        return opt_state, dict(aux, loss=loss, grad_norm=gnorm)

    @torch.no_grad()
    def eval_step(self, buffers: dict, batch: dict, noise: NoiseSource,
                  n_members: int = 4) -> dict[str, torch.Tensor]:
        """One-step fair CRPS (the batch mean of the nodal CRPS) and
        ensemble-mean RMSE (the mean over batch and channels) of
        ``n_members``.

        In the domain decomposition, on this rank's rows: the whole
        (n_members, B) noise drawn and projected on the rows,
        ``DomainFCN3``'s forward, the nodal CRPS through ``dist_crps`` on
        a group of this rank alone over its points with its rows' area
        weights, and the per-(b, c) weighted squared errors of the
        ensemble mean; both summed over the latitude group (the RMSE's
        before its square root), then averaged over the data group: the
        values of the data group's batch."""
        m, d, p = self.model, self.domain, self.par
        fwd, area = self.fwd, self.area_weights
        if d is not None:
            area = area[slice(*d.io_block)]
        nbufs = buffers["noise"]
        state = batch["state"]                      # (B, C, H_loc, W)
        b, c = state.shape[:2]
        z_hat = noise.initial(m, (n_members, b * (p.n_data if d else 1)),
                              nbufs)
        z = m.noise.to_grid(self._members(z_hat) if d else z_hat, nbufs)
        aux_n = batch["aux"][:, 0]
        cond = torch.cat(
            [aux_n.expand((n_members,) + tuple(aux_n.shape)), z], dim=2)
        pred = fwd(buffers, state.expand((n_members,) + tuple(state.shape)),
                   cond)
        tgt = batch["targets"][:, 0]
        sq = torch.einsum("bchw,hw->bc", (pred.mean(dim=0) - tgt) ** 2, area)
        if d is None:
            nodal = crpslib.nodal_crps_loss(
                pred, tgt, area, fair=True,
                blocks=self.model.cfg.kernels.blocks_for("crps"))
            return {"crps": nodal.mean(), "rmse_ens_mean": sq.sqrt().mean()}
        from repro_torch.distributed.dist_crps import dist_crps
        # the nodal CRPS per point, weighted by area / (B C): its sum over
        # every rank's points is the mean over (b, c) of eq. (50)
        crps = dist_crps(pred.reshape(pred.shape[:3] + (-1,)),
                         tgt.reshape(tgt.shape[:2] + (-1,)),
                         area.reshape(-1) / (b * c), d.solo, fair=True,
                         blocks=self.model.cfg.kernels.blocks_for("crps"))
        sums = compat.psum(torch.cat([crps[None], sq.reshape(-1)]), d.group)
        out = torch.stack([sums[0], torch.sqrt(sums[1:]).mean()])
        if p.data_group is not None:
            out = compat.psum(out, p.data_group) / p.n_data
        return {"crps": out[0], "rmse_ens_mean": out[1]}


def estimate_wdt(samples: torch.Tensor) -> np.ndarray:
    """Temporal channel weights w_{dt,c}, paper eq. (49).

    samples: (N, T, C, H, W) consecutive states; weight = 1 / std of the
    one-step differences, per channel (population std).
    """
    diff = samples[:, 1:] - samples[:, :-1]
    std = diff.float().std(dim=(0, 1, 3, 4), correction=0).cpu().numpy()
    return 1.0 / np.maximum(std, 1e-6)
