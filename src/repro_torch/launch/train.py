"""FCN3 ensemble training (paper Appendix E curriculum), one process.

Runs on the CUDA card unless ``--device cpu`` is given; without a card
and without that flag it exits with an error instead of running on the
CPU.  Calibrated init from ``--seed``, then one line per step:

  step    i loss=... nodal=... spectral=... |g|=... (s)

  PYTHONPATH=src python -m repro_torch.launch.train --config smoke \
      --steps 2 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Iterator

import torch

from repro_torch.configs import fcn3 as fcn3cfg
from repro_torch.core.fcn3 import FCN3
from repro_torch.data import era5_synthetic as dlib
from repro_torch.inference.engine import GeneratorNoise
from repro_torch.runtime import resolve_device
from repro_torch.train import checkpoint as ckptlib
from repro_torch.train import trainer as trlib

CONFIGS = fcn3cfg.NAMED_CONFIGS
STAGES = {s.name: s for s in fcn3cfg.FCN3_CURRICULUM}


def stage_to_tcfg(stage: fcn3cfg.FCN3TrainingStage, ensemble: int | None,
                  rollout: int | None) -> trlib.TrainConfig:
    """The stage's ``TrainConfig``, with ensemble / rollout overrides."""
    return trlib.TrainConfig(
        ensemble_size=ensemble or stage.ensemble_size,
        rollout_steps=rollout or stage.rollout_steps,
        fair_crps=stage.fair_crps,
        noise_centering=stage.name == "finetune",
        lr=stage.lr, lr_halve_every=stage.lr_halve_every,
    )


def build_parser() -> argparse.ArgumentParser:
    """The train CLI's argument parser (the JAX CLI's flags + --device)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="smoke", choices=sorted(CONFIGS))
    ap.add_argument("--stage", default="pretrain_stage1",
                    choices=sorted(STAGES))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--ensemble", type=int, default=2)
    ap.add_argument("--rollout", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    return ap


def _generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


@dataclasses.dataclass
class TrainRun:
    """A set-up training run: the model, its trainer and buffers, the
    batch iterator and the optimizer state."""

    model: FCN3
    trainer: trlib.EnsembleTrainer
    buffers: dict
    batches: Iterator[dict]
    opt_state: dict
    steps_done: int = 0


def setup(config: str, stage: str, batch: int = 1,
          ensemble: int | None = 2, rollout: int | None = None,
          seed: int = 0, device: str = "cuda", calibration_rounds: int = 4,
          report=print) -> TrainRun:
    """Build the model, calibrate it on the first batch and make the
    optimizer state (the JAX CLI's set-up)."""
    dev = resolve_device(device)
    cfg = CONFIGS[config]()
    st = STAGES[stage]
    tcfg = stage_to_tcfg(st, ensemble, rollout)
    report(f"[train] config={config} stage={st.name} "
           f"E={tcfg.ensemble_size} rollout={tcfg.rollout_steps} "
           f"fair={tcfg.fair_crps} lr={tcfg.lr} on {dev}")
    model = FCN3(cfg, device=dev)
    ds = dlib.SyntheticERA5(cfg, device=dev)
    loader = dlib.Loader(ds, global_batch=batch,
                         rollout=tcfg.rollout_steps, seed=seed)
    tr = trlib.EnsembleTrainer(model, tcfg,
                               fcn3cfg.channel_weights(cfg.n_levels))
    buffers = dict(model.make_buffers(), **tr.make_loss_buffers())
    it = iter(loader)
    batch0 = next(it)
    cond0 = torch.cat([batch0["aux"][:, 0],
                       model.sample_noise(_generator(dev, 1), (batch,))],
                      dim=1)
    model.init_calibrated(_generator(dev, seed), batch0["state"], cond0,
                          buffers, calibration_rounds)
    params = dict(model.named_parameters())
    report(f"[train] {sum(p.numel() for p in params.values()):,} "
           "parameters")
    return TrainRun(model, tr, buffers, it, tr.optimizer.init(params))


def run_steps(run: TrainRun, steps: int, report=print) -> list[dict]:
    """``steps`` optimizer steps, one ``step`` line each; returns each
    step's diagnostics as floats."""
    dev = run.model.device
    history = []
    t0 = time.time()
    for _ in range(steps):
        i = run.steps_done
        run.opt_state, aux = run.trainer.train_step(
            run.buffers, run.opt_state, next(run.batches),
            GeneratorNoise(_generator(dev, 1000 + i)))
        vals = {k: float(v) for k, v in aux.items()}
        history.append(vals)
        run.steps_done += 1
        report(f"step {i:4d} loss={vals['loss']:.5f} "
               f"nodal={vals['nodal_0']:.5f} "
               f"spectral={vals['spectral_0']:.5f} "
               f"|g|={vals['grad_norm']:.3f} ({time.time() - t0:.1f}s)")
    return history


def train(config: str, stage: str, steps: int, batch: int = 1,
          ensemble: int | None = 2, rollout: int | None = None,
          ckpt_dir: str | None = None, seed: int = 0, device: str = "cuda",
          calibration_rounds: int = 4, report=print) -> list[dict]:
    """``setup``, ``run_steps`` and, with ``ckpt_dir``, a checkpoint of
    the parameters and optimizer state."""
    run = setup(config, stage, batch, ensemble, rollout, seed, device,
                calibration_rounds, report)
    history = run_steps(run, steps, report)
    if ckpt_dir:
        path = ckptlib.save_checkpoint(
            ckpt_dir, run.steps_done, dict(run.model.named_parameters()),
            run.opt_state)
        report(f"[train] checkpoint written to {path}")
    return history


def main(argv: list[str] | None = None) -> None:
    """Run the train CLI."""
    args = build_parser().parse_args(argv)
    train(args.config, args.stage, args.steps, args.batch, args.ensemble,
          args.rollout, args.ckpt_dir, args.seed, args.device)


if __name__ == "__main__":
    main()
