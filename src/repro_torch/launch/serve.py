"""Ensemble-forecast serving: an N-member FCN3 forecast scored in the loop.

Runs on the CUDA card unless ``--device cpu`` is given; without a card
and without that flag it exits with an error instead of running on the
CPU.  Prints one line per lead with the channel-mean fair CRPS,
ensemble-mean RMSE and spread-skill ratio against the synthetic truth;
raw fields are never written.  Engine options:

* ``--precision bfloat16``  the bf16 policy: bf16 parameters, buffers
                       and carried state, fp32 products and scores;
* ``--kernels {auto,reference,kernel}``  path of the SHT and DISCO
                       contractions (auto: the config's own, the kernels);
* ``--perturb {none,obs,bred}``  initial-condition perturbations (paper
                       App. E), antithetically centered, scaled by the
                       dataset's climatological statistics;
* ``--calibration``    per-degree energy spectra in the loop and a
                       calibration line per lead (rank-histogram
                       flatness, spectral ratio);
* ``--scores-out F``   every score array of the rollout to ``F`` (.npz).

  PYTHONPATH=src python -m repro_torch.launch.serve --config smoke \
      --members 4 --lead-steps 2 --perturb obs --calibration --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import fcn3 as fcn3cfg
from repro_torch.core.fcn3 import FCN3
from repro_torch.data import era5_synthetic as dlib
from repro_torch.inference import perturbations as perturblib
from repro_torch.inference.engine import (EngineConfig, ForecastEngine,
                                          ForecastResult, members_noise)
from repro_torch.inference.params import load_params
from repro_torch.kernels.config import KernelConfig
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
    ap.add_argument("--precision", default="float32",
                    choices=["float32", "bfloat16"],
                    help="model compute dtype; scores stay fp32")
    ap.add_argument("--kernels", default="auto",
                    choices=["auto", "reference", "kernel"],
                    help="path of the SHT/DISCO contractions (auto: the "
                         "config's own)")
    ap.add_argument("--perturb", default="none",
                    choices=list(perturblib.PERTURB_KINDS),
                    help="initial-condition perturbation of the members")
    ap.add_argument("--perturb-amplitude", type=float, default=0.05,
                    help="perturbation size as a fraction of the "
                         "climatological channel std")
    ap.add_argument("--bred-cycles", type=int, default=3,
                    help="breeding cycles for --perturb bred")
    ap.add_argument("--ensemble-transform", action="store_true",
                    help="orthogonalize bred-vector pairs against each "
                         "other every cycle instead of only renormalizing")
    ap.add_argument("--calibration", action="store_true",
                    help="in-loop per-degree energy spectra and a "
                         "calibration line per lead")
    ap.add_argument("--scores-out", default=None,
                    help="save every score array to this .npz file")
    ap.add_argument("--sample", type=int, default=123)
    ap.add_argument("--ckpt", default=None,
                    help="reference checkpoint (directory with arrays.npz)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    return ap


def check_members(members: int, pcfg: perturblib.PerturbationConfig) -> None:
    """Refuse a member count the centered ensemble cannot take, before
    any model work (the reference's up-front check)."""
    problems = perturblib.validate_member_count(members, centered=True,
                                                cfg=pcfg)
    if problems:
        raise ValueError("; ".join(problems))


@dataclasses.dataclass
class ServeRun:
    """A built model, its data and its calibrated parameters."""

    model: FCN3
    ds: dlib.SyntheticERA5
    buffers: dict
    state0: torch.Tensor
    sample: int


def setup(config: str, sample: int = 123, ckpt: str | None = None,
          device: str = "cuda", calibration_rounds: int = 4) -> ServeRun:
    """Build the model and its data on ``device``; load or calibrate the
    parameters."""
    dev = resolve_device(device)
    cfg = CONFIGS[config]()
    model = FCN3(cfg, device=dev)
    ds = dlib.SyntheticERA5(cfg, device=dev)
    buffers = model.make_buffers()
    state0 = ds.state(sample, 0)
    load_params(model, ds, buffers, state0, ckpt, rounds=calibration_rounds)
    return ServeRun(model, ds, buffers, state0, sample)


def calibration_line(block: ForecastResult, i: int) -> str:
    """Lead ``i`` of a block: channel-mean rank-histogram flatness (max /
    min bin frequency; 1 = flat) and the median forecast/truth spectral
    ratio over the lower half of the degrees (1 = neither blurred nor
    blown up)."""
    rh = block.scores["rank_hist"][i].float().mean(0)
    spec = block.scores["spectrum"][i]
    spec_t = block.scores["spectrum_truth"][i]
    lo = spec.shape[-1] // 2
    ratio = (spec[:, 1:lo] / spec_t[:, 1:lo].clamp_min(1e-12)).quantile(0.5)
    return (f"          rank-hist flatness="
            f"{float(rh.max() / rh.min().clamp_min(1e-12)):.2f} "
            f"spectral ratio={float(ratio):.3f}")


def serve(config: str, members: int, lead_steps: int, lead_chunk: int = 8,
          sample: int = 123, ckpt: str | None = None, device: str = "cuda",
          calibration_rounds: int = 4, report=print,
          precision: str = "float32", kernels: str = "auto",
          perturb: perturblib.PerturbationConfig
          = perturblib.PerturbationConfig(),
          calibration: bool = False, scores_out: str | None = None,
          run: ServeRun | None = None) -> list[ForecastResult]:
    """Build the model (or take ``run``), load/calibrate params and run
    the scored rollout.

    Returns the per-chunk results; ``report`` gets one line per lead (and
    a calibration line after each with ``calibration``).
    """
    check_members(members, perturb)
    if run is None:
        run = setup(config, sample, ckpt, device, calibration_rounds)
    model, ds = run.model, run.ds
    perturbation = (perturblib.InitialConditionPerturbation.from_dataset(
        model.in_sht, perturb, ds) if perturb.active else None)
    eng = ForecastEngine(model, EngineConfig(
        members=members, lead_chunk=lead_chunk, compute_dtype=precision,
        perturb=perturb, spectra=calibration,
        kernels=None if kernels == "auto" else KernelConfig(kernels,
                                                            kernels)),
        perturbation=perturbation)
    t0 = time.time()
    report(f"[serve] {members}-member ensemble, {lead_steps} x 6h lead on "
           f"{model.device} ({precision}, perturb={perturb.kind})")
    results = []
    collected: dict[str, list[np.ndarray]] = {}
    for block in eng.stream(run.buffers, run.state0,
                            lambda n: ds.aux_fields(6.0 * (n + 1)),
                            members_noise(model, 7), steps=lead_steps,
                            truth=lambda n: ds.state(run.sample, n + 1)):
        results.append(block)
        if scores_out:
            for name, arr in block.scores.items():
                collected.setdefault(name, []).append(arr.cpu().numpy())
        for i, n in enumerate(block.lead_steps):
            report(f"lead {6 * (int(n) + 1):4d}h  "
                   f"CRPS={float(block.scores['crps'][i].mean()):.4f} "
                   f"ensRMSE={float(block.scores['ens_rmse'][i].mean()):.4f} "
                   f"SSR={float(block.scores['ssr'][i].mean()):.3f} "
                   f"({time.time() - t0:.1f}s)")
            if calibration:
                report(calibration_line(block, i))
    if scores_out:
        scores = {k: np.concatenate(v) for k, v in collected.items()}
        np.savez(scores_out, **scores)
        report(f"[serve] scores -> {scores_out} ({', '.join(sorted(scores))})")
    report("[serve] done -- no fields written to disk (in-loop scoring)")
    return results


def main(argv: list[str] | None = None) -> None:
    """Run the serve CLI."""
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        pcfg = perturblib.PerturbationConfig(
            kind=args.perturb, amplitude=args.perturb_amplitude,
            bred_cycles=args.bred_cycles,
            ensemble_transform=args.ensemble_transform)
        check_members(args.members, pcfg)
    except ValueError as e:
        ap.error(str(e))
    serve(args.config, args.members, args.lead_steps, args.lead_chunk,
          args.sample, args.ckpt, args.device, precision=args.precision,
          kernels=args.kernels, perturb=pcfg, calibration=args.calibration,
          scores_out=args.scores_out)


if __name__ == "__main__":
    main()
