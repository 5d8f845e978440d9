"""Hybrid data / domain parallelism with the PyTorch port, the twin of
``examples/distributed_training.py``: a world of ``--data`` x ``--model``
processes (4 x 2 by default) over gloo.

This is the paper's §4/G contribution end-to-end and at miniature scale:
the computational domain (latitude) is decomposed across the "model" axis
while batch samples shard across "data" -- both the activations AND the
training data are split (Fig. 2).  Each rank loads the loader's row block
of its sample and runs ``distributed.domain.DomainFCN3``: the halo
exchanges, Algorithm 1's distributed SHT and the ensemble CRPS over the
rank's rows, written by hand where the JAX package has GSPMD insert them
(``python -m repro_torch.distributed.selftest`` holds Algorithms 1-3 to
one process).  The world is ``distributed/world.py::run_world``: spawned
processes joined through a file store, on the CUDA card unless
``--device cpu`` is asked for (several ranks share one card over gloo).
The JAX example's ``REPRO_DFT_MODE=matmul`` has no twin: the port has one
DFT mode.

Run:  PYTHONPATH=src python examples/distributed_training_torch.py \\
          [--data 4 --model 2] [--device cpu]
"""

import argparse

import torch

from repro_torch.configs import fcn3 as fcn3cfg
from repro_torch.core.fcn3 import FCN3
from repro_torch.data import era5_synthetic as dlib
from repro_torch.distributed import sharding
from repro_torch.distributed.world import run_world
from repro_torch.inference.engine import GeneratorNoise
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime import resolve_device
from repro_torch.train import trainer as trlib


def generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def rank_main(rank: int, world_size: int, n_data: int, n_model: int,
              steps: int, device: str) -> list[str]:
    """One rank's part: its lines to print (every rank's step lines are
    the same)."""
    dev = resolve_device(device)
    mesh = make_mesh((n_data, n_model), ("data", "model"), dev.type)
    cfg = fcn3cfg.fcn3_smoke()
    model = FCN3(cfg, device=dev)
    model.init(generator(dev, 0))
    tcfg = trlib.TrainConfig(ensemble_size=2, rollout_steps=1, lr=1e-3)
    # a mesh and no member axes: latitude over "model", the batch over
    # "data" (rank 0's parameters are broadcast here)
    tr = trlib.EnsembleTrainer(model, tcfg,
                               fcn3cfg.channel_weights(cfg.n_levels), mesh)
    buffers = dict(tr.domain.make_buffers(), **tr.make_loss_buffers())

    # global batch of one sample per data rank; this rank loads its sample
    # on its latitude rows, as the batch's specs place them
    spec = sharding.fcn3_batch_specs(
        {"state": torch.empty((n_data, 1, 1, 1), device="meta")},
        ("data",))["state"]
    (d, nd), lat = (sharding.block_of(spec[0], mesh),
                    sharding.block_of(spec[-2], mesh))
    ds = dlib.SyntheticERA5(cfg, device=dev)
    loader = iter(dlib.Loader(ds, global_batch=n_data, rollout=1, rank=d,
                              world=nd, lat_shard=lat))
    params = dict(model.named_parameters())
    opt_state = tr.optimizer.init(params)
    lines = [f"mesh: {{'data': {n_data}, 'model': {n_model}}} "
             f"(data-parallel x domain-decomposition) on {dev}"]
    for i in range(steps):
        opt_state, aux = tr.train_step(buffers, opt_state, next(loader),
                                       GeneratorNoise(generator(dev, i)))
        lines.append(f"step {i}: loss={float(aux['loss']):.4f} "
                     f"|g|={float(aux['grad_norm']):.3f}")

    # show where a weight and this rank's activations live
    name = next(iter(params))
    wspec = sharding.fcn3_param_specs(params)[name]
    lines.append(f"example weight placement: {name} "
                 f"{tuple(params[name].shape)} spec={wspec} -> "
                 f"{sharding.to_placements(wspec, mesh)}")
    lines.append(f"rank {rank}: latitude rows {tr.domain.io_block} of "
                 f"{cfg.nlat} (IO), {tr.domain.lat_block} of "
                 f"{cfg.latent_nlat} (latent)")
    return lines


def main(device: str = "cuda", data: int = 4, model: int = 2,
         steps: int = 3) -> None:
    dev = resolve_device(device)
    lines = run_world(rank_main, data * model,
                      (data, model, steps, dev.type), backend="gloo",
                      timeout=600.0)
    for line in lines[0]:
        print(line)
    print(lines[-1][-1])
    print("distributed training OK "
          "(see repro_torch/distributed/selftest.py for Alg. 1-3 exactness)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    ap.add_argument("--data", type=int, default=4,
                    help="ranks along the data axis (batch)")
    ap.add_argument("--model", type=int, default=2,
                    help="ranks along the model axis (latitude)")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    main(args.device, args.data, args.model, args.steps)
