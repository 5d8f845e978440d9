"""The train mode: back-to-back ``EnsembleTrainer.train_step`` calls on
fresh seeded samples, one process, one card.

Set-up makes a pool of samples on the host, builds the model, its
trainer, buffers and Adam state, loads the seed's weights and takes the
first ``check_steps`` steps through the window's own call and feed.  The
window takes further steps until ``--seconds`` have passed and ends on a
step boundary (``--trace 1``: a profiled run of ``trace_steps`` steps).
``correct`` then holds the first steps to the plain reference, which
takes the same steps from the same weights, samples and noise: each
step's loss, each leaf's first gradient as Adam received it (read from
its first moment) and each leaf's change over the checked steps.
"""

from __future__ import annotations

import math
import statistics
import sys
import time

import torch

from perfbench import device as card
from perfbench import harness, inputs
from perfbench.reference import fcn3 as ref


class Data:
    """``pool`` batches of (state, targets, aux) on the host, cycled."""

    def __init__(self, cell: harness.Cell, cfg: ref.ModelConfig, seed: int,
                 dev: torch.device):
        c, tr = cell.config, cell.traffic
        b, t = c["batch_size"], c["rollout_steps"]
        fields = inputs.Fields(cfg, dev)
        pin = dev.type == "cuda"
        self.pool = []
        for i in range(tr["pool"]):
            states, targets, auxs = [], [], []
            for j in range(b):
                sample = inputs.sub_seed(seed, "sample", i, j) % 1_000_000
                traj = fields.trajectory(seed, sample, t)
                t_hours = 6.0 * (sample % 1460)
                states.append(traj[0].cpu())
                targets.append(torch.stack(traj[1:]).cpu())
                auxs.append(torch.stack([torch.as_tensor(
                    fields.aux(t_hours + 6.0 * k)) for k in range(t)]))
            batch = {"state": torch.stack(states),
                     "targets": torch.stack(targets),
                     "aux": torch.stack(auxs)}
            self.pool.append({k: v.pin_memory() if pin else v
                              for k, v in batch.items()})
        self.dev = dev

    def batch(self, i: int) -> dict:
        """Step ``i``'s batch on the card."""
        return {k: v.to(self.dev, non_blocking=True)
                for k, v in self.pool[i % len(self.pool)].items()}


def noise_draws(cfg: ref.ModelConfig, c: dict, seed: int, i: int,
                dev: torch.device) -> inputs.NoiseDraws:
    """Step ``i``'s noise draws for (E, B) members."""
    return inputs.NoiseDraws(cfg, seed, f"train.{i}",
                             (c["ensemble_size"], c["batch_size"]), dev)


class Program:
    """The port's trainer with its model, buffers and Adam state."""

    def __init__(self, cell: harness.Cell, cfg: ref.ModelConfig, seed: int,
                 dev: torch.device):
        from repro_torch.core.fcn3 import FCN3, FCN3Config
        from repro_torch.train.trainer import EnsembleTrainer, TrainConfig
        c = cell.config
        self.model = FCN3(FCN3Config(**c["model"]), device=dev)
        inputs.load_weights(self.model, inputs.draw_weights(cfg, seed, dev))
        self.trainer = EnsembleTrainer(self.model, TrainConfig(
            ensemble_size=c["ensemble_size"],
            rollout_steps=c["rollout_steps"], fair_crps=c["fair_crps"],
            lambda_spectral=c["lambda_spectral"], noise_centering=False,
            lr=c["lr"], lr_halve_every=c["lr_halve_every"],
            clip_norm=c["clip_norm"]), cfg.channel_weights())
        self.buffers = self.model.make_buffers()
        self.buffers.update(self.trainer.make_loss_buffers())
        self.opt_state = self.trainer.optimizer.init(
            dict(self.model.named_parameters()))

    def step(self, batch: dict, draws: inputs.NoiseDraws) -> torch.Tensor:
        """One optimizer step on ``batch`` with the noise of ``draws``;
        its loss on the card."""
        from repro_torch.inference.engine import InjectedNoise
        self.opt_state, aux = self.trainer.train_step(
            self.buffers, self.opt_state, batch,
            InjectedNoise(draws.z_hat0(), draws))
        return aux["loss"]

    def first_gradient_norms(self) -> dict[str, float]:
        """Each leaf's norm of the gradient Adam's first step received:
        its first moment over (1 - b1)."""
        b1 = self.trainer.optimizer.b1
        mu = self.opt_state["mu"]
        norms = torch.stack([m.norm() for m in mu.values()]) / (1.0 - b1)
        return dict(zip(mu, norms.tolist()))

    def change_norms(self, p0: dict) -> dict[str, float]:
        """Each leaf's norm of its change from ``p0``."""
        params = dict(self.model.named_parameters())
        norms = torch.stack([(p.detach() - p0[k]).norm()
                             for k, p in params.items()])
        return dict(zip(params, norms.tolist()))


def leaf_gaps(got: dict[str, float], want: dict[str, float],
              leaves) -> list[float]:
    """Each leaf's gap |got - want|, over the larger of the leaf's
    reference norm and the median leaf's, sorted."""
    med = statistics.median(want[k] for k in leaves)
    return sorted(abs(got[k] - want[k]) / max(want[k], med) for k in leaves)


def share_within(gaps: list[float], share: float) -> float:
    """The gap that ``share`` of the (sorted) leaves stay within."""
    return gaps[int(share * len(gaps))]


def reference_run(cell: harness.Cell, cfg: ref.ModelConfig, seed: int,
                  data: Data, dev: torch.device, steps: int,
                  control: bool = False, one_member: bool = False) -> dict:
    """The plain reference's first ``steps`` steps: their losses, each
    leaf's first (clipped) gradient norm and each leaf's change.  With
    ``control`` its products run in TF32: the control's run.  With
    ``one_member`` every member is the first one's forecast (the fault
    of a batch half left out, planted in the reference)."""
    if control:
        with card.tf32():
            return reference_run(cell, cfg, seed, data, dev, steps,
                                 one_member=one_member)
    c = cell.config
    e, b = c["ensemble_size"], c["batch_size"]
    geo = ref.Geometry.create(cfg, dev)
    P = inputs.draw_weights(cfg, seed, dev)
    for p in P.values():
        p.requires_grad_(True)
    adam = ref.Adam(c["lr"], c["lr_halve_every"], c["clip_norm"])
    losses, grad1 = [], None
    for i in range(steps):
        batch = data.batch(i)
        draws = noise_draws(cfg, c, seed, i, dev)
        z_hat = draws.z_hat0()
        s = batch["state"].expand((e,) + tuple(batch["state"].shape))
        total = 0.0
        t = batch["targets"].shape[1]
        for n in range(t):
            z = geo.io_sht.inverse(z_hat)
            aux = batch["aux"][:, n]
            cond = torch.cat([aux.expand((e,) + tuple(aux.shape)), z], dim=2)
            if one_member:
                s = ref.step(geo, P, s[:1], cond[:1]).expand(s.shape)
            else:
                s = ref.step(geo, P, s, cond)
            total = total + ref.objective(geo, s, batch["targets"][:, n],
                                          c["fair_crps"],
                                          c["lambda_spectral"]) / t
            if n + 1 < t:
                z_hat = ref.sphere.NOISE_PHI * z_hat + draws[n]
        grads = torch.autograd.grad(total, list(P.values()))
        clipped = adam.update(P, dict(zip(P, grads)))
        losses.append(float(total.detach()))
        if i == 0:
            grad1 = {k: float(g.norm()) for k, g in clipped.items()}
        del grads, clipped, total, s
    p0 = inputs.draw_weights(cfg, seed, dev)
    change = {k: float((P[k].detach() - p0[k]).norm()) for k in P}
    return {"losses": losses, "grad1": grad1, "change": change}


def worst_leaves(got: dict, want: dict, n: int = 3) -> str:
    """The ``n`` leaves with the widest gaps of the first gradient and of
    the change, for the look at a reading."""
    parts = []
    for key in ("grad1", "change"):
        med = statistics.median(want[key].values())
        gaps = sorted(((abs(got[key][k] - want[key][k])
                        / max(want[key][k], med), k) for k in want[key]),
                      reverse=True)[:n]
        parts.append(f"{key}: " + ", ".join(
            f"{k} {g:.3g} ({got[key][k]:.6g} vs {want[key][k]:.6g})"
            for g, k in gaps))
    return "; ".join(parts)


def readings(prog: dict, want: dict) -> dict[str, float]:
    """``loss_err``, the worst step's relative loss gap; ``grad_err``
    and ``grad_p90``, the worst leaf's and the ninth-decile leaf's gap
    of the first gradient; ``change_err``, ``change_p90`` and
    ``change_p50``, the worst, the ninth-decile and the median leaf's
    gap of each leaf's change over the checked steps.  The change leaves
    out leaves whose reference gradient is under a thousandth of the
    median leaf's (they would move by round-off alone).  Adam's later
    steps turn round-off in a few small leaves (layer scales, biases)
    into gaps of their change that swing from seed to seed in the fp32
    reference too, so the cells compare the median leaf's change."""
    leaves = list(want["grad1"])
    med = statistics.median(want["grad1"].values())
    moving = [k for k in leaves if want["grad1"][k] >= 1e-3 * med]
    grad = leaf_gaps(prog["grad1"], want["grad1"], leaves)
    change = leaf_gaps(prog["change"], want["change"], moving)
    return {
        "loss_err": max(abs(g - w) / abs(w) for g, w in
                        zip(prog["losses"], want["losses"])),
        "grad_err": grad[-1], "grad_p90": share_within(grad, 0.9),
        "change_err": change[-1], "change_p90": share_within(change, 0.9),
        "change_p50": share_within(change, 0.5),
    }


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device: str, t0: float, fault=None) -> dict:
    """One run of a train cell; returns ``harness.emit``'s arguments.
    ``fault`` (tests only) breaks the trainer under the timed path."""
    dev = torch.device(device)
    c, tr = cell.config, cell.traffic
    cfg = ref.ModelConfig.of(c["model"])
    checked = tr["check_steps"]
    card.reset_peak(dev)
    card.fp32_only()
    data = Data(cell, cfg, seed, dev)
    card.sync(dev)
    prog = Program(cell, cfg, seed, dev)
    if fault is not None:
        fault(prog)

    def step(i):
        return prog.step(data.batch(i), noise_draws(cfg, c, seed, i, dev))

    losses = []
    bookkeeping = 0.0
    got = {}
    for i in range(checked):
        losses.append(step(i))
        if i == 0:
            tb = time.perf_counter()
            got["grad1"] = prog.first_gradient_norms()
            bookkeeping += time.perf_counter() - tb
    card.sync(dev)
    tb = time.perf_counter()
    got["change"] = prog.change_norms(inputs.draw_weights(cfg, seed, dev))
    card.free(dev)
    bookkeeping += time.perf_counter() - tb
    setup_s = time.perf_counter() - t0 - bookkeeping

    window = []
    with card.Profiled(trace) as prof:
        tw = time.perf_counter()
        while True:
            with torch.profiler.record_function("bench.step"):
                window.append(step(checked + len(window)))
                card.sync(dev)
            if (len(window) >= tr["trace_steps"] if trace
                    else time.perf_counter() - tw >= seconds):
                break
        window_s = time.perf_counter() - tw
    traced = prof.trace(window_s)
    peak = card.peak_bytes(dev)
    got["losses"] = [float(v) for v in losses]
    failed = sum(int(not math.isfinite(float(v))) for v in window)
    del prog
    card.free(dev)
    t_ref = time.perf_counter()
    want = reference_run(cell, cfg, seed, data, dev, checked)
    print(f"reference check {time.perf_counter() - t_ref:.3f} s, "
          f"{checked} steps; worst leaves: {worst_leaves(got, want)}",
          file=sys.stderr)
    correct, checks = harness.judge(readings(got, want), cell.limits)

    n = len(window)
    return harness.result(
        cell, correct=correct, attempted=n, failed=failed, checks=checks,
        device=card.record(dev, peak),
        values={"setup_s": setup_s, "peak_mem_gb": peak / 1e9,
                "train_step_s": window_s / n},
        traced=traced, work={"steps": n})
