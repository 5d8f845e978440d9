"""The benchmark's cells at the port's ``fcn3_smoke`` widths, for the
CPU tests: the same traffic and limits, a model small enough for a test
process."""

from __future__ import annotations

import copy

from perfbench import harness

#: ``repro_torch.configs.fcn3.fcn3_smoke``'s widths
SMOKE_MODEL = dict(
    nlat=33, nlon=64, grid="equiangular", latent_nlat=16, latent_nlon=32,
    latent_grid="gauss", n_levels=2, n_atmos=5, n_surface=7, n_aux=4,
    n_noise=8, atmos_embed=10, surface_embed=14, cond_embed=12, n_blocks=2,
    global_block_every=2, mlp_hidden=32, encoder_cutoff=3.0,
    latent_cutoff=3.0, filter_ell_max=2, filter_m_max=2,
    layer_scale_init=1e-3)


#: limits of ``correct`` at the smoke widths on the CPU, where the
#: program runs its plain versions: sound runs read under a tenth of
#: each (the cells' own limits are set at their published widths on the
#: card; a 26-leaf model's ninth-decile leaf is its third worst)
SMOKE_LIMITS = {"start_err": 1e-5, "step_err": 1e-5, "score_err": 1e-5,
                "loss_err": 1e-5, "grad_err": 3e-2, "grad_p90": 5e-3,
                "change_p50": 5e-3}


def smoke_cell(name: str) -> harness.Cell:
    """Cell ``name`` of the manifest with the smoke model's widths, a
    rollout of 12 leads, the smoke limits and no work constants."""
    cell = copy.deepcopy(harness.load_cell(name))
    cell.config["model"] = dict(SMOKE_MODEL)
    cell.config["work"] = {}    # the constants are the published widths'
    cell.limits = {k: SMOKE_LIMITS[k] for k in cell.limits}
    if "leads" in cell.traffic:
        cell.traffic["leads"] = 12
    return cell
