"""Quickstart: train a miniature FourCastNet 3 end-to-end with the PyTorch
port (``repro_torch``), the twin of ``examples/quickstart.py``.

Demonstrates the public API surface:
  * config -> model -> buffers -> calibrated init        (paper C)
  * spherical diffusion noise conditioning               (paper B.7)
  * ensemble training with the nodal+spectral CRPS loss  (paper E.1)
  * an ensemble forecast with in-loop scores             (paper 5/G.4)

The forecast runs on ``repro_torch.inference.ForecastEngine``: the FCN3
step, the AR(1) noise transition, antithetic centering and the CRPS /
RMSE / spread / rank-histogram scores stay on the device for the whole
rollout, seeded by observation-error perturbations of the initial
condition (paper App. E).  Every draw comes from an explicit
``torch.Generator``.  It runs on the CUDA card; ``--device cpu`` must be
asked for.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import torch

from repro_torch.configs import fcn3 as fcn3cfg
from repro_torch.core.fcn3 import FCN3
from repro_torch.data import era5_synthetic as dlib
from repro_torch.inference.engine import (EngineConfig, ForecastEngine,
                                          GeneratorNoise)
from repro_torch.inference.perturbations import (
    InitialConditionPerturbation, PerturbationConfig)
from repro_torch.runtime import resolve_device
from repro_torch.train import trainer as trlib


def generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def main(device: str = "cuda", train_steps: int = 5, members: int = 4,
         leads: int = 4) -> None:
    dev = resolve_device(device)
    # 1. Model: a reduced FCN3 (same architecture family as the paper's
    #    710M-parameter production model, Table 2).
    cfg = fcn3cfg.fcn3_smoke()
    model = FCN3(cfg, device=dev)
    buffers = model.make_buffers()

    # 2. Data: the deterministic spectrally shaped ERA5 surrogate.
    ds = dlib.SyntheticERA5(cfg, device=dev)
    loader = iter(dlib.Loader(ds, global_batch=1, rollout=1))
    batch = next(loader)

    # 3. Calibrated init (paper C.6: variance-preserving, no LayerNorm).
    cond0 = torch.cat([batch["aux"][:, 0],
                       model.sample_noise(generator(dev, 1), (1,))], dim=1)
    model.init_calibrated(generator(dev, 0), batch["state"], cond0, buffers)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"FCN3 ({n_params:,} params), grid {cfg.nlat}x{cfg.nlon} -> "
          f"latent {cfg.latent_nlat}x{cfg.latent_nlon} on {dev}")

    # 4. A few CRPS ensemble training steps (pre-training stage 1 recipe).
    tcfg = trlib.TrainConfig(ensemble_size=2, rollout_steps=1, lr=1e-3)
    tr = trlib.EnsembleTrainer(model, tcfg,
                               fcn3cfg.channel_weights(cfg.n_levels))
    train_bufs = dict(buffers, **tr.make_loss_buffers())
    opt_state = tr.optimizer.init(dict(model.named_parameters()))
    for i in range(train_steps):
        opt_state, aux = tr.train_step(train_bufs, opt_state, next(loader),
                                       GeneratorNoise(generator(dev, i)))
        print(f"step {i}: loss={float(aux['loss']):.4f} "
              f"(nodal={float(aux['nodal_0']):.4f}, "
              f"spectral={float(aux['spectral_0']):.4f})")
    model.requires_grad_(False)

    # 5. A 4-member, 4-step ensemble forecast with in-loop scoring against
    #    the verifying states: no raw field leaves the device.  Members
    #    are seeded by obs-error perturbations -- Gaussian fields with the
    #    data's climatological spectrum, scaled per channel and
    #    antithetically centered.
    pcfg = PerturbationConfig(kind="obs", amplitude=0.1)
    eng = ForecastEngine(
        model, EngineConfig(members=members, lead_chunk=leads,
                            perturb=pcfg),
        perturbation=InitialConditionPerturbation.from_dataset(
            model.in_sht, pcfg, ds))
    res = eng.forecast(buffers, ds.state(999),
                       lambda n: ds.aux_fields(6.0 * n),
                       GeneratorNoise(generator(dev, 2)), steps=leads,
                       truth=lambda n: ds.state(999, n + 1))
    for i, lead in enumerate(res.lead_steps):
        # rank-histogram flatness (max/min bin of the channel-mean
        # histogram): 1 = perfectly calibrated; see docs/calibration.md.
        rh = res.scores["rank_hist"][i].float().mean(0)
        print(f"lead {(int(lead) + 1) * 6}h: "
              f"CRPS={float(res.scores['crps'][i].mean()):.4f} "
              f"SSR={float(res.scores['ssr'][i].mean()):.3f} "
              f"rank-hist flatness="
              f"{float(rh.max() / rh.min().clamp_min(1e-12)):.2f}")
    print("quickstart OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    main(ap.parse_args().device)
