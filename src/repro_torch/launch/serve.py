"""Ensemble-forecast serving: an N-member FCN3 forecast scored in the loop.

Runs on the CUDA card unless ``--device cpu`` is given; without a card
and without that flag it exits with an error instead of running on the
CPU.  Prints one line per lead with the channel-mean fair CRPS,
ensemble-mean RMSE and spread-skill ratio against the synthetic truth.

  PYTHONPATH=src python -m repro_torch.launch.serve --config smoke \
      --members 2 --lead-steps 2 --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import fcn3 as fcn3cfg
from repro_torch.core.fcn3 import FCN3
from repro_torch.data import era5_synthetic as dlib
from repro_torch.inference.engine import (EngineConfig, ForecastEngine,
                                          ForecastResult, members_noise)
from repro_torch.inference.params import load_params
from repro_torch.runtime import resolve_device

CONFIGS = fcn3cfg.NAMED_CONFIGS


def build_parser() -> argparse.ArgumentParser:
    """The serve CLI's argument parser."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="smoke", choices=sorted(CONFIGS))
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--lead-steps", type=int, default=8)
    ap.add_argument("--lead-chunk", type=int, default=8,
                    help="leads per result block")
    ap.add_argument("--sample", type=int, default=123)
    ap.add_argument("--ckpt", default=None,
                    help="reference checkpoint (directory with arrays.npz)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    return ap


def serve(config: str, members: int, lead_steps: int, lead_chunk: int = 8,
          sample: int = 123, ckpt: str | None = None, device: str = "cuda",
          calibration_rounds: int = 4, report=print) -> list[ForecastResult]:
    """Build the model, load/calibrate params and run the scored rollout.

    Returns the per-chunk results; ``report`` gets one line per lead.
    """
    if members % 2:
        raise ValueError("antithetic noise centering needs an even member "
                         f"count, got {members}")
    dev = resolve_device(device)
    cfg = CONFIGS[config]()
    model = FCN3(cfg, device=dev)
    ds = dlib.SyntheticERA5(cfg, device=dev)
    buffers = model.make_buffers()
    state0 = ds.state(sample, 0)
    load_params(model, ds, buffers, state0, ckpt, rounds=calibration_rounds)

    eng = ForecastEngine(model, EngineConfig(members=members,
                                             lead_chunk=lead_chunk))
    t0 = time.time()
    report(f"[serve] {members}-member ensemble, {lead_steps} x 6h lead on "
           f"{dev}")
    results = []
    for block in eng.stream(buffers, state0,
                            lambda n: ds.aux_fields(6.0 * (n + 1)),
                            members_noise(model, 7), steps=lead_steps,
                            truth=lambda n: ds.state(sample, n + 1)):
        results.append(block)
        for i, n in enumerate(block.lead_steps):
            report(f"lead {6 * (int(n) + 1):4d}h  "
                   f"CRPS={float(block.scores['crps'][i].mean()):.4f} "
                   f"ensRMSE={float(block.scores['ens_rmse'][i].mean()):.4f} "
                   f"SSR={float(block.scores['ssr'][i].mean()):.3f} "
                   f"({time.time() - t0:.1f}s)")
    report("[serve] done -- no fields written to disk (in-loop scoring)")
    return results


def main(argv: list[str] | None = None) -> None:
    """Run the serve CLI."""
    args = build_parser().parse_args(argv)
    serve(args.config, args.members, args.lead_steps, args.lead_chunk,
          args.sample, args.ckpt, args.device)


if __name__ == "__main__":
    main()
