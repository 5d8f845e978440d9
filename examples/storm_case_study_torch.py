"""Case study: ensemble spread around an intense synthetic cyclone, with
the PyTorch port (``repro_torch``), the twin of
``examples/storm_case_study.py``.

Mirrors the paper's storm-Dennis case study (Fig. 4): initialize from a
state containing a strong vortex, seed the ensemble with cycled bred
vectors (paper App. E -- perturbations aligned with the flow's
fastest-growing directions, so members diverge into genuinely different
storm scenarios instead of shedding unstructured noise), run an ensemble
forecast, and inspect (a) per-member wind-speed maxima (different members
= different scenarios), (b) the angular power spectral density of the
forecast vs truth -- the paper's headline result is that FCN3 keeps
realistic spectra at long leads.  Both come from the engine's
``diagnostics`` callback, reduced on the device every lead.  Every draw
comes from an explicit ``torch.Generator``.  It runs on the CUDA card;
``--device cpu`` must be asked for.

Run:  PYTHONPATH=src python examples/storm_case_study_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import fcn3 as fcn3cfg
from repro_torch.core.fcn3 import FCN3
from repro_torch.data import era5_synthetic as dlib
from repro_torch.evaluation import metrics
from repro_torch.inference.engine import (EngineConfig, ForecastEngine,
                                          GeneratorNoise)
from repro_torch.inference.perturbations import (
    InitialConditionPerturbation, PerturbationConfig)
from repro_torch.runtime import resolve_device


def add_vortex(state: torch.Tensor, grid, lat0=0.9, lon0=2.0,
               radius=0.25, amp=4.0) -> torch.Tensor:
    """Superimpose a cyclonic anomaly on the u/v wind channels of a
    (C, H, W) state (a new tensor)."""
    th = torch.as_tensor(grid.colat, dtype=state.dtype,
                         device=state.device)[:, None]
    ph = torch.as_tensor(grid.lons, dtype=state.dtype,
                         device=state.device)[None, :]
    d2 = (th - lat0) ** 2 + (torch.cos(th) * (ph - lon0)) ** 2
    core = amp * torch.exp(-d2 / (2 * radius ** 2))
    # azimuthal winds around the core
    du = -core * (th - lat0) / radius
    dv = core * torch.cos(th) * (ph - lon0) / radius
    nl = 2  # smoke config has 2 levels
    state = state.clone()
    state[2 * nl:3 * nl] += du[None]   # u channels
    state[3 * nl:4 * nl] += dv[None]   # v channels
    return state


def generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def main(device: str = "cuda", members: int = 4, leads: int = 6,
         bred_cycles: int = 2) -> None:
    dev = resolve_device(device)
    cfg = fcn3cfg.fcn3_smoke()
    model = FCN3(cfg, device=dev)
    ds = dlib.SyntheticERA5(cfg, device=dev)
    buffers = model.make_buffers()

    state0 = add_vortex(ds.state(7), ds.grid)
    cond0 = torch.cat([ds.aux_fields(0.0)[None],
                       model.sample_noise(generator(dev, 1), (1,))], dim=1)
    model.init_calibrated(generator(dev, 0), state0[None], cond0, buffers)

    nl = cfg.n_levels
    uidx, vidx = 2 * nl, 3 * nl  # lowest-level u/v channels
    wpct = model.in_sht.buffers(dev)["wpct"]
    truth_psd = metrics.angular_psd(state0[uidx], wpct).cpu().numpy()

    # In-loop diagnostics, called by the engine on each lead's ensemble:
    # per-member wind maxima and the member-0 u-wind angular PSD, reduced
    # on the device -- raw member fields never leave it.
    def storm_diag(ens: torch.Tensor) -> dict[str, torch.Tensor]:
        wind = torch.sqrt(ens[:, uidx] ** 2 + ens[:, vidx] ** 2)
        return {"wind_max": wind.amax(dim=(-2, -1)),
                "psd_u0": metrics.angular_psd(ens[0, uidx], wpct)}

    # Bred-vector seeding: two cycles of perturb -> integrate -> rescale
    # grow the initial perturbations along the vortex's unstable
    # directions before the forecast starts (all on the device).
    pcfg = PerturbationConfig(kind="bred", amplitude=0.1,
                              bred_cycles=bred_cycles)
    eng = ForecastEngine(model, EngineConfig(members=members,
                                             lead_chunk=leads, perturb=pcfg),
                         diagnostics=storm_diag,
                         perturbation=InitialConditionPerturbation
                         .from_dataset(model.in_sht, pcfg, ds))
    res = eng.forecast(buffers, state0, lambda n: ds.aux_fields(6.0 * n),
                       GeneratorNoise(generator(dev, 3)), steps=leads)

    print("lead   member wind maxima (m/s, normalized units)     PSD ratio")
    lo = slice(1, cfg.latent_nlat // 2)
    for i, lead in enumerate(res.lead_steps):
        maxima = [f"{float(w):5.2f}"
                  for w in res.diagnostics["wind_max"][i].cpu()]
        psd = res.diagnostics["psd_u0"][i].cpu().numpy()
        ratio = float(np.median(psd[lo] / np.maximum(truth_psd[lo], 1e-12)))
        print(f"{(int(lead) + 1) * 6:3d}h   {maxima}   {ratio:8.3f}")
    print("\nDifferent members give different storm scenarios; the PSD "
          "ratio staying O(1)\nindicates no spectral blow-up or blurring "
          "across the rollout (paper Fig. 4/5).")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    main(ap.parse_args().device)
