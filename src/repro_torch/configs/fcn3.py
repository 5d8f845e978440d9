"""FCN3 variable table, training curriculum and named model configs
(paper Tables 1-4).

Source: Bonev et al., "FourCastNet 3: A geometric approach to probabilistic
machine-learning weather forecasting at scale", 2025.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.fcn3 import FCN3Config

PRESSURE_LEVELS = (50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925,
                   1000)  # hPa, 13 levels
ATMOS_VARS = ("z", "t", "u", "v", "q")
SURFACE_VARS = ("u10m", "v10m", "u100m", "v100m", "t2m", "msl", "tcwv")
SURFACE_WC = (0.1, 0.1, 0.1, 0.1, 1.0, 0.1, 0.1)  # Table 4
AUX_VARS = ("lsm_land", "lsm_sea", "orography", "cos_zenith")


def channel_names(n_levels: int = 13) -> list[str]:
    """State channel order: [13*z, 13*t, 13*u, 13*v, 13*q, surface...]."""
    levels = PRESSURE_LEVELS[:n_levels]
    names = [f"{v}{p}" for v in ATMOS_VARS for p in levels]
    return names + list(SURFACE_VARS)


def channel_weights(n_levels: int = 13) -> np.ndarray:
    """Per-channel loss weights w_c (Table 4): p*1e-3 for level p, else 0.1/1."""
    levels = np.asarray(PRESSURE_LEVELS[:n_levels], np.float64)
    atmos = np.tile(levels * 1e-3, len(ATMOS_VARS))
    return np.concatenate([atmos, np.asarray(SURFACE_WC)])


def water_channel_names(n_levels: int = 13) -> list[str]:
    """The channels the softclamp applies to: specific humidity and tcwv."""
    return [f"q{p}" for p in PRESSURE_LEVELS[:n_levels]] + ["tcwv"]


@dataclasses.dataclass(frozen=True)
class FCN3TrainingStage:
    """One row of Table 3."""

    name: str
    steps: int
    rollout_steps: int
    batch_size: int
    ensemble_size: int
    lr: float
    lr_halve_every: int | None   # None = constant LR
    fair_crps: bool
    dataset: str                 # descriptive


FCN3_CURRICULUM = (
    FCN3TrainingStage("pretrain_stage1", 208_320, 1, 16, 16, 5e-4, None,
                      False, "1-hourly 1980-2016"),
    FCN3TrainingStage("pretrain_stage2", 5_040, 4, 32, 2, 4e-4, 840,
                      True, "6-hourly 1980-2016"),
    FCN3TrainingStage("finetune", 4_380, 8, 4, 4, 4e-6, 1_095,
                      True, "6-hourly 2012-2016"),
)


def fcn3_full() -> FCN3Config:
    """The paper's 0.25-degree production model (Table 2)."""
    return FCN3Config()


def fcn3_smoke() -> FCN3Config:
    """Reduced variant for CPU tests: 2 operator blocks, tiny grids."""
    return FCN3Config(
        nlat=33, nlon=64, latent_nlat=16, latent_nlon=32,
        n_levels=2, atmos_embed=10, surface_embed=14, cond_embed=12,
        n_blocks=2, global_block_every=2, mlp_hidden=32,
    )


def fcn3_small() -> FCN3Config:
    """~1 degree research variant runnable on one host."""
    return FCN3Config(
        nlat=181, nlon=360, latent_nlat=90, latent_nlon=180,
        n_levels=5, atmos_embed=20, surface_embed=21, cond_embed=12,
        n_blocks=5, global_block_every=5, mlp_hidden=256,
    )


#: Named model configs shared by every entry point.
NAMED_CONFIGS = {
    "smoke": fcn3_smoke,
    "small": fcn3_small,
    "full": fcn3_full,
}
