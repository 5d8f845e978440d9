"""WB2-style evaluation protocol (paper F.1) with in-situ scoring.

Scores an FCN3 ensemble against the (synthetic-ERA5) ground truth over many
initial conditions and lead times, per channel -- the structure of the
paper's Figures 3/12-18: fair CRPS, ensemble-mean RMSE, ACC, spread-skill
ratio, rank histograms and angular PSD ratios.  Everything is computed
online (paper G.4): no forecast fields ever touch the disk; only the score
tables are emitted (CSV + optional JSON), laid out as the JAX package's
``repro.launch.evaluate`` lays them out.

Each lead is one ``ForecastEngine.step`` of the members (centered AR(1)
noise, the model step, the noise transition); initial condition ``ic``
starts from sample ``1000 + 37 ic`` and draws its noise from
``noises(ic)``, a ``NoiseSource`` (by default a generator seeded from
``--seed`` and ``ic``).  Runs on the CUDA card unless ``--device cpu`` is
given; without a card it exits with an error.

  PYTHONPATH=src python -m repro_torch.launch.evaluate --config smoke \\
      --members 4 --lead-steps 4 --initial-conditions 4 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import fcn3 as fcn3cfg
from repro_torch.core.fcn3 import FCN3
from repro_torch.data import era5_synthetic as dlib
from repro_torch.evaluation import metrics
from repro_torch.inference.engine import (EngineConfig, ForecastEngine,
                                          NoiseSource, members_noise)
from repro_torch.inference.params import load_params
from repro_torch.launch.train import load_init
from repro_torch.runtime import resolve_device

CONFIGS = fcn3cfg.NAMED_CONFIGS

# WB2 headline channels present in our channel table (paper F.2)
HEADLINE = ("z500", "t850", "t2m", "u10m", "msl", "q700")


class OnlineScores:
    """Streaming accumulator: mean scores over initial conditions."""

    def __init__(self, n_members: int):
        self.n = 0
        self.sums: dict[str, np.ndarray] = {}
        self.rank_hist = np.zeros(n_members + 1)

    def update(self, scores: dict[str, np.ndarray],
               rank_hist: np.ndarray) -> None:
        """Add one initial condition's scores and rank frequencies."""
        for k, v in scores.items():
            self.sums[k] = self.sums.get(k, 0.0) + np.asarray(v)
        self.rank_hist += np.asarray(rank_hist)
        self.n += 1

    def means(self) -> dict[str, np.ndarray]:
        """The scores' means over the initial conditions so far, and the
        normalized rank histogram."""
        out = {k: v / max(self.n, 1) for k, v in self.sums.items()}
        out["rank_hist"] = self.rank_hist / max(self.rank_hist.sum(), 1)
        return out


def make_score_fn(model: FCN3, aw: torch.Tensor, clim: torch.Tensor,
                  wpct: torch.Tensor):
    """``score(ens, truth)``: per-channel fair CRPS, ensemble-mean RMSE,
    ACC of the ensemble mean, spread-skill ratio and the median over
    degrees l >= 1 of member 0's angular PSD over the truth's; and
    ``ranks(ens, truth)``: the area-weighted rank histogram.  ens is
    (E, C, H, W), truth (C, H, W)."""

    def score(ens: torch.Tensor, truth: torch.Tensor) -> dict:
        ratio = (metrics.angular_psd(ens[0], wpct)[..., 1:]
                 / metrics.angular_psd(truth, wpct)[..., 1:].clamp_min(1e-12))
        return {
            "crps": metrics.crps(ens, truth, aw, fair=True),
            "rmse_ens_mean": metrics.ensemble_skill(ens, truth, aw),
            "acc": metrics.acc(ens.mean(dim=0), truth, clim, aw),
            "ssr": metrics.spread_skill_ratio(ens, truth, aw),
            # the median of an even count averages the middle two, as
            # numpy's does
            "psd_ratio": torch.quantile(ratio, 0.5, dim=-1),
        }

    def ranks(ens: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
        return metrics.rank_histogram(ens, truth, aw)

    return score, ranks


def build_parser() -> argparse.ArgumentParser:
    """The evaluate CLI's argument parser (the reference's flags and
    ``--device``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="smoke", choices=sorted(CONFIGS))
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--lead-steps", type=int, default=4)
    ap.add_argument("--initial-conditions", type=int, default=4)
    ap.add_argument("--ckpt", default=None,
                    help="reference checkpoint (a ckpt_* directory)")
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    return ap


def main(argv: list[str] | None = None,
         noises: Callable[[int], NoiseSource] | None = None,
         data=None, report=print) -> dict:
    """Run the protocol; returns the results table (``results`` of the
    JSON: ``lead_{6h}h`` -> metric -> per-channel list).

    ``noises(ic)`` gives initial condition ``ic``'s noise source (its
    ``eta(model, lead, ...)`` the draw after lead ``lead``); ``data``
    replaces the synthetic dataset (``state(sample, offset)``,
    ``aux_fields(t_hours)``), so a test can hand in another package's
    draws and fields."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = CONFIGS[args.config]()
    model = FCN3(cfg, device=dev)
    ds = data if data is not None else dlib.SyntheticERA5(cfg, device=dev)
    buffers = model.make_buffers()
    names = fcn3cfg.channel_names(cfg.n_levels)
    aw = torch.from_numpy(model.grid_in.area_weights_2d().astype(
        np.float32)).to(dev)
    clim = dlib.climatology(ds).to(dev)
    wpct, _ = model.in_sht.tables()
    wpct = torch.from_numpy(wpct.astype(np.float32)).to(dev)
    if args.ckpt:
        load_init(model, args.ckpt)
    else:
        load_params(model, ds, buffers, ds.state(0), seed=args.seed)
    if noises is None:
        def noises(ic: int) -> NoiseSource:
            return members_noise(model, args.seed * 100_003 + ic)

    score_fn, rank_fn = make_score_fn(model, aw, clim, wpct)
    e = args.members
    eng = ForecastEngine(model, EngineConfig(members=e))
    per_lead = [OnlineScores(e) for _ in range(args.lead_steps)]
    t0 = time.time()
    for ic in range(args.initial_conditions):
        sample = 1000 + 37 * ic
        noise = noises(ic)
        with torch.inference_mode():
            state0 = torch.as_tensor(ds.state(sample)).to(dev)
            ens = state0.expand((e,) + tuple(state0.shape))[None]
            z_hat = noise.initial(model, (e,), eng.noise_buffers)[None]
            for lead in range(args.lead_steps):
                aux = torch.as_tensor(ds.aux_fields(6.0 * lead)).to(dev)
                eta = noise.eta(model, lead, z_hat[0], eng.noise_buffers)
                ens, z_hat = eng.step(None, buffers, ens, z_hat, aux[None],
                                      eta[None])
                truth = torch.as_tensor(ds.state(sample, lead + 1)).to(dev)
                per_lead[lead].update(
                    {k: v.cpu().numpy()
                     for k, v in score_fn(ens[0], truth).items()},
                    rank_fn(ens[0], truth).cpu().numpy())
        report(f"[evaluate] ic {ic + 1}/{args.initial_conditions} "
               f"({time.time() - t0:.1f}s)")

    # ---- report ----------------------------------------------------------
    head_idx = [names.index(n) for n in HEADLINE if n in names]
    head = [names[i] for i in head_idx]
    report("\nlead_h,metric," + ",".join(head))
    results = {}
    for lead, acc in enumerate(per_lead):
        m = acc.means()
        results[f"lead_{6 * (lead + 1)}h"] = {
            k: np.asarray(v).tolist() for k, v in m.items()}
        for metric in ("crps", "rmse_ens_mean", "acc", "ssr", "psd_ratio"):
            vals = m[metric][head_idx] if len(m[metric].shape) else m[metric]
            report(f"{6 * (lead + 1)},{metric},"
                   + ",".join(f"{v:.4f}" for v in np.atleast_1d(vals)))
    report("\nrank histogram (last lead): "
           + str(np.round(per_lead[-1].means()["rank_hist"], 3).tolist()))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump({"channels": names, "headline": head,
                       "results": results}, f, indent=1)
        report(f"[evaluate] wrote {args.out_json}")
    report("[evaluate] done (in-situ scoring; no forecast fields stored)")
    return results


if __name__ == "__main__":
    main()
