"""FCN3 ensemble training (paper Appendix E curriculum).

Runs on the CUDA card unless ``--device cpu`` is given; without a card
and without that flag it exits with an error instead of running on the
CPU.  Calibrated init from ``--seed`` (or the parameters of the
checkpoint ``--init-from``), then one line per step:

  step    i loss=... nodal=... spectral=... |g|=... (s)

  PYTHONPATH=src python -m repro_torch.launch.train --config smoke \
      --steps 2 --device cpu

Under ``torchrun`` (``WORLD_SIZE`` > 1) it trains on a ``("data",
"model")`` mesh of ``--mesh-data`` x ``--mesh-model`` ranks, the batch
over the data axis.  ``--fcn3-sharding`` (the JAX dry run's flag) says
what the model axis carries: ``domain`` (the default, as there) latitude
-- each rank loads and computes the loader's row block of every field,
the domain-decomposed step of ``distributed.domain`` -- ``ensemble``
the members (ensemble parallelism, ``TrainConfig.member_axes =
("model", "data")``; an ensemble the model ranks do not divide is
whole on each of them) and ``channel`` the latent channels
(``distributed.channel``: the parameters ``fcn3_param_specs(mode=
"channel")`` splits, each rank holding its blocks, every rank all
members on the whole fields of its slice of the batch).  A checkpoint
is written whole by rank 0 (a channel run's split leaves gathered
first), in the reference's format.  The process group uses
``--dist-backend`` (nccl by default on ``cuda``, gloo on ``cpu``), as
the caller names it: nothing switches it.  NCCL takes one card per
rank; several ranks on one card take gloo, which stages each collective
through host memory.  Each rank prints a
``[dist]`` line: its seconds per step, the share spent in collectives,
its row blocks and halo bytes per step (domain), its members (ensemble)
or its split leaves (channel), its kernel launches and its peak memory.

  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
      --config smoke --device cpu --fcn3-sharding domain --mesh-model 2 \
      --steps 2
  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
      --config smoke --device cpu --fcn3-sharding channel --mesh-model 2 \
      --steps 2
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from typing import Iterator

import torch

from repro_torch.configs import fcn3 as fcn3cfg
from repro_torch.core.fcn3 import FCN3
from repro_torch.data import era5_synthetic as dlib
from repro_torch.distributed import compat, sharding
from repro_torch.inference import params as paramslib
from repro_torch.inference.engine import GeneratorNoise
from repro_torch.runtime import resolve_device
from repro_torch.train import checkpoint as ckptlib
from repro_torch.train import trainer as trlib

CONFIGS = fcn3cfg.NAMED_CONFIGS
STAGES = {s.name: s for s in fcn3cfg.FCN3_CURRICULUM}


#: the axes of the training mesh; with ``--fcn3-sharding ensemble`` the
#: ensemble rides the model axis, as the JAX package's dry run puts it
#: (``member_axes=("model", dp)``)
MESH_AXES = ("data", "model")
MEMBER_AXES = ("model", "data")
SHARDINGS = ("domain", "ensemble", "channel")


def stage_to_tcfg(stage: fcn3cfg.FCN3TrainingStage, ensemble: int | None,
                  rollout: int | None, member_axes: tuple | None = None
                  ) -> trlib.TrainConfig:
    """The stage's ``TrainConfig``, with ensemble / rollout overrides."""
    return trlib.TrainConfig(
        ensemble_size=ensemble or stage.ensemble_size,
        rollout_steps=rollout or stage.rollout_steps,
        fair_crps=stage.fair_crps,
        noise_centering=stage.name == "finetune",
        lr=stage.lr, lr_halve_every=stage.lr_halve_every,
        member_axes=member_axes,
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
    ap.add_argument("--init-from", default=None,
                    help="start from this checkpoint's parameters (a "
                         "ckpt_* directory, or the latest one under a "
                         "directory) instead of the calibrated init")
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="ranks along the data axis (batch)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="ranks along the model axis (latitude or "
                         "ensemble, as --fcn3-sharding says)")
    ap.add_argument("--fcn3-sharding", choices=SHARDINGS, default="domain",
                    help="what the model axis carries: latitude (domain "
                         "decomposition), the ensemble members or the "
                         "latent channels")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default=None, help="process-group backend: nccl by "
                    "default on cuda, gloo on cpu")
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


def load_init(model: FCN3, path: str) -> str:
    """Load the parameters of the checkpoint ``path`` (a ``ckpt_*``
    directory, or the latest one under it) into ``model``; returns the
    checkpoint's directory."""
    if not os.path.exists(os.path.join(path, "manifest.json")):
        latest = ckptlib.latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
        path = latest
    params, _, _ = ckptlib.restore_checkpoint(path)
    paramslib.load_into(model, paramslib.params_to_numpy(params))
    return path


def setup(config: str, stage: str, batch: int = 1,
          ensemble: int | None = 2, rollout: int | None = None,
          seed: int = 0, device: str = "cuda", calibration_rounds: int = 4,
          report=print, mesh=None, init_from: str | None = None,
          sharding_mode: str = "domain") -> TrainRun:
    """Build the model, calibrate it on the first batch (or load the
    parameters of ``init_from``) and make the optimizer state (the JAX
    CLI's set-up).  With ``mesh`` (axes ``MESH_AXES``) this rank loads
    its slice of each batch, the trainer is domain-decomposed or
    ensemble-parallel as ``sharding_mode`` says, and the parameters are
    rank 0's (in the domain decomposition only rank 0 calibrates, on the
    whole field of its first batch); in channel mode the trainer keeps
    each rank's blocks of rank 0's split parameters."""
    import torch.distributed as dist
    if sharding_mode not in SHARDINGS:
        raise ValueError(f"--fcn3-sharding {sharding_mode}")
    dev = resolve_device(device)
    cfg = CONFIGS[config]()
    st = STAGES[stage]
    domain = mesh is not None and sharding_mode == "domain"
    tcfg = stage_to_tcfg(st, ensemble, rollout,
                         MEMBER_AXES if mesh is not None
                         and sharding_mode == "ensemble" else None)
    report(f"[train] config={config} stage={st.name} "
           f"E={tcfg.ensemble_size} rollout={tcfg.rollout_steps} "
           f"fair={tcfg.fair_crps} lr={tcfg.lr} on {dev}")
    model = FCN3(cfg, device=dev)
    ds = dlib.SyntheticERA5(cfg, device=dev)
    data_block, lat_block = (0, 1), (0, 1)
    if mesh is not None:
        # the batch's placement is the rules': the batch over the data
        # axis, latitude over the model axis in the domain decomposition
        # and whole when the model axis carries the ensemble or the
        # channels
        spec = sharding.fcn3_batch_specs(
            {"state": torch.empty((batch, 1, 1, 1), device="meta")},
            (MESH_AXES[0],), model_axis=MESH_AXES[1] if domain else None,
            mode="channel" if sharding_mode == "channel" else "domain"
        )["state"]
        data_block, lat_block = (sharding.block_of(spec[0], mesh),
                                 sharding.block_of(spec[-2], mesh))

    def loader(lat_shard):
        return dlib.Loader(ds, global_batch=batch,
                           rollout=tcfg.rollout_steps, seed=seed,
                           rank=data_block[0], world=data_block[1],
                           lat_shard=lat_shard)
    it = iter(loader(lat_block))
    batch0 = next(it)                 # calibrates; training starts after
    buffers = None
    if init_from:
        report(f"[train] parameters from {load_init(model, init_from)}")
    elif not domain or dist.get_rank() == 0:
        if domain:
            batch0 = next(iter(loader((0, 1))))
        buffers = model.make_buffers()
        cond0 = torch.cat([batch0["aux"][:, 0], model.sample_noise(
            _generator(dev, 1), (batch0["state"].shape[0],))], dim=1)
        model.init_calibrated(_generator(dev, seed), batch0["state"], cond0,
                              buffers, calibration_rounds)
    del batch0
    tr = trlib.EnsembleTrainer(
        model, tcfg, fcn3cfg.channel_weights(cfg.n_levels), mesh,
        placement="channel" if mesh is not None
        and sharding_mode == "channel" else "domain")
    if tr.domain is not None:
        # this rank's slices of the plans only
        buffers = tr.domain.make_buffers()
        report(f"[train] domain decomposition: latitude over "
               f"{tr.par.n_model} ranks, IO rows {tr.domain.io_block} of "
               f"{cfg.nlat}, latent rows {tr.domain.lat_block} of "
               f"{cfg.latent_nlat}")
    elif buffers is None:
        buffers = model.make_buffers()
    if tr.channel is not None:
        whole = sum(int(math.prod(s)) for k, s in tr.channel.shapes.items()
                    if k in tr.split)
        report(f"[train] channel parallelism: {len(tr.split)} leaves "
               f"({whole:,} parameters) split over {tr.par.n_model} ranks")
    buffers.update(tr.make_loss_buffers())
    params = dict(model.named_parameters())
    report(f"[train] {sum(p.numel() for p in params.values()):,} "
           "parameters")
    return TrainRun(model, tr, buffers, it, tr.optimizer.init(params))


def run_steps(run: TrainRun, steps: int, report=print) -> list[dict]:
    """``steps`` optimizer steps, one ``step`` line each; returns each
    step's diagnostics as floats, with its ``seconds``, the seconds
    ``collective_s`` spent in collectives, the bytes ``halo_bytes`` its
    halo exchanges brought this rank and ``kind_bytes``, each kind of
    collective's output bytes on this rank (``compat.timed_kinds``)."""
    dev = run.model.device
    history = []
    t0 = time.time()
    for _ in range(steps):
        i = run.steps_done
        compat.start_timing()
        ts = time.time()
        run.opt_state, aux = run.trainer.train_step(
            run.buffers, run.opt_state, next(run.batches),
            GeneratorNoise(_generator(dev, 1000 + i)))
        vals = {k: float(v) for k, v in aux.items()}
        vals.update(seconds=time.time() - ts,
                    collective_s=compat.timed_seconds(),
                    halo_bytes=compat.timed_bytes(),
                    kind_bytes=compat.timed_kinds())
        history.append(vals)
        run.steps_done += 1
        report(f"step {i:4d} loss={vals['loss']:.5f} "
               f"nodal={vals['nodal_0']:.5f} "
               f"spectral={vals['spectral_0']:.5f} "
               f"|g|={vals['grad_norm']:.3f} ({time.time() - t0:.1f}s)")
    return history


def dist_line(run: TrainRun, history: list[dict]) -> str:
    """This rank's ``[dist]`` line: seconds per step, the share in
    collectives, its row blocks and halo bytes per step (domain) or its
    members (ensemble), each kind of collective's bytes per step, kernel
    launches, peak memory."""
    import torch.distributed as dist
    from repro_torch.kernels.crps import ops as crps_ops
    from repro_torch.kernels.disco import ops as disco_ops
    from repro_torch.kernels.legendre import ops as legendre_ops
    dev = run.model.device
    tr = run.trainer
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f}"
            if dev.type == "cuda" else "n/a")
    if tr.domain is not None:
        where = (f"io_rows={tr.domain.io_block} "
                 f"latent_rows={tr.domain.lat_block} halo_bytes="
                 f"{[int(h['halo_bytes']) for h in history]}")
    elif tr.whole_members:
        where = (f"members={tr.tcfg.ensemble_size} (whole) "
                 f"split_leaves={len(tr.split)}")
    else:
        where = f"members={tr.tcfg.ensemble_size // tr.par.n_model}"
    where += " bytes_by_kind=" + str(
        [{k: v for k, v in h["kind_bytes"].items() if v}
         for h in history])
    return (f"[dist] rank {dist.get_rank()}/{dist.get_world_size()} {where}"
            f" step_s={[round(h['seconds'], 3) for h in history]} "
            f"collective_share="
            f"{[round(h['collective_s'] / h['seconds'], 3) for h in history]}"
            f" band_launches={disco_ops.launches} "
            f"transpose_launches={disco_ops.transpose_launches} "
            f"legendre_launches={legendre_ops.launches} "
            f"crps_launches={crps_ops.launches} "
            f"crps_bwd_launches={crps_ops.bwd_launches} peak_mem_gb={peak}")


def train(config: str, stage: str, steps: int, batch: int = 1,
          ensemble: int | None = 2, rollout: int | None = None,
          ckpt_dir: str | None = None, seed: int = 0, device: str = "cuda",
          calibration_rounds: int = 4, report=print, mesh=None,
          init_from: str | None = None, rank_report=None,
          sharding_mode: str = "domain") -> list[dict]:
    """``setup``, ``run_steps`` and, with ``ckpt_dir``, a checkpoint of
    the parameters and optimizer state, whole (gathered from the ranks'
    blocks in channel mode; every rank must pass ``ckpt_dir`` then, and
    rank 0 writes it).  With ``mesh``, each rank's ``[dist]`` line goes
    to ``rank_report`` after the steps."""
    import torch.distributed as dist
    run = setup(config, stage, batch, ensemble, rollout, seed, device,
                calibration_rounds, report, mesh, init_from, sharding_mode)
    history = run_steps(run, steps, report)
    if mesh is not None and rank_report is not None:
        rank_report(dist_line(run, history))
    if ckpt_dir:
        params, opt_state = run.trainer.whole_state(run.opt_state)
        if mesh is None or dist.get_rank() == 0:
            path = ckptlib.save_checkpoint(ckpt_dir, run.steps_done, params,
                                           opt_state)
            report(f"[train] checkpoint written to {path}")
    return history


def init_distributed(device: str, backend: str | None, mesh_data: int,
                     mesh_model: int, report=print):
    """The ``("data", "model")`` mesh of a run of several processes, or
    ``None`` for a run of one.

    A process group already set up by the caller is used as it is;
    otherwise, when ``WORLD_SIZE`` > 1 (``torchrun``), one is joined
    through the environment (``env://``) with the caller's backend
    (``None``: nccl on cuda, gloo on cpu).
    """
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if mesh_data * mesh_model != world:
        raise SystemExit(f"--mesh-data {mesh_data} x --mesh-model "
                         f"{mesh_model} != world size {world}")
    if world == 1:
        return None
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                                  % torch.cuda.device_count())
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"))
    per_card = (-(-world // torch.cuda.device_count())
                if dev.type == "cuda" else None)
    if dist.get_rank() == 0:
        report(f"[dist] backend={dist.get_backend()} world={world} mesh="
               f"{dict(zip(MESH_AXES, (mesh_data, mesh_model)))} on "
               f"{dev.type}" + (f", {per_card} ranks per card"
                                if per_card else ""))
    return make_mesh((mesh_data, mesh_model), MESH_AXES, dev.type)


def main(argv: list[str] | None = None) -> list[dict]:
    """Run the train CLI; returns this rank's step diagnostics."""
    import torch.distributed as dist
    args = build_parser().parse_args(argv)
    joined = dist.is_available() and dist.is_initialized()
    mesh = init_distributed(args.device, args.dist_backend, args.mesh_data,
                            args.mesh_model)
    if mesh is None:
        return train(args.config, args.stage, args.steps, args.batch,
                     args.ensemble, args.rollout, args.ckpt_dir, args.seed,
                     args.device, init_from=args.init_from)
    rank = dist.get_rank()
    try:
        return train(args.config, args.stage, args.steps, args.batch,
                     args.ensemble, args.rollout, args.ckpt_dir, args.seed,
                     args.device, report=print if rank == 0 else _quiet,
                     mesh=mesh, init_from=args.init_from, rank_report=print,
                     sharding_mode=args.fcn3_sharding)
    finally:
        if not joined:
            dist.destroy_process_group()


def _quiet(line: str) -> None:
    pass


if __name__ == "__main__":
    main()
