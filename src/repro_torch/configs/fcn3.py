"""Named FCN3 model configs (paper Table 2).

Source: Bonev et al., "FourCastNet 3: A geometric approach to probabilistic
machine-learning weather forecasting at scale", 2025.
"""

from __future__ import annotations

from repro_torch.core.fcn3 import FCN3Config


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
