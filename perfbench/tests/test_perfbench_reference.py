"""The plain reference against the port at ``fcn3_smoke`` on the CPU:
its tables, one step of the model, one lead of the engine with its
scores and one train step, each through the harness as a run drives it."""

import numpy as np
import pytest
import torch

from perfbench import harness, inputs
from perfbench.reference import fcn3 as ref
from perfbench.reference import sphere
from perfbench.tests.smoke import SMOKE_MODEL, smoke_cell

CFG = ref.ModelConfig.of(SMOKE_MODEL)
SEED = 2**31 + 977


@pytest.fixture(scope="module")
def port():
    from repro_torch.core.fcn3 import FCN3, FCN3Config
    torch.manual_seed(0)
    model = FCN3(FCN3Config(**SMOKE_MODEL), device="cpu")
    inputs.load_weights(model, inputs.draw_weights(CFG, SEED, "cpu"))
    return model


def test_tables_match_the_port(port):
    geo = ref.Geometry.create(CFG, "cpu")
    for mine, plan in ((geo.enc, port.enc_plan), (geo.latent,
                                                  port.latent_plan),
                       (geo.dec, port.dec_plan)):
        np.testing.assert_allclose(mine.psi.numpy(), plan.psi, rtol=0,
                                   atol=1e-6 * np.abs(plan.psi).max())
        np.testing.assert_array_equal(mine.lat_idx.numpy(), plan.lat_idx)
    wpct, pct = port.latent_sht.tables()
    np.testing.assert_allclose(geo.latent_sht.pct.numpy(), pct, atol=1e-6)
    np.testing.assert_allclose(geo.latent_sht.wpct.numpy(), wpct, atol=1e-6)


def test_one_step_matches_the_port(port):
    geo = ref.Geometry.create(CFG, "cpu")
    g = torch.Generator().manual_seed(3)
    state = torch.randn((2, CFG.n_state, CFG.nlat, CFG.nlon), generator=g)
    cond = torch.randn((2, CFG.n_aux + CFG.n_noise, CFG.nlat, CFG.nlon),
                       generator=g)
    with torch.no_grad():
        want = ref.step(geo, inputs.draw_weights(CFG, SEED, "cpu"), state,
                        cond)
        got = port(port.make_buffers(), state, cond)
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-5


@pytest.mark.parametrize("cell", ["forecast.e4", "forecast.e4_scored",
                                  "train.stage2"])
def test_a_run_at_smoke_size_is_correct(cell):
    c = smoke_cell(cell)
    res = harness.mode_module(c.mode).run(c, seed=SEED, seconds=0.5,
                                          trace=False, device="cpu", t0=0.0)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


def test_noise_draws_repeat_and_differ_by_lead():
    d = inputs.NoiseDraws(CFG, SEED, "t", (2,), "cpu")
    assert torch.equal(d[3], d[3]) and not torch.equal(d[3], d[4])
    z2 = sphere.NOISE_PHI * (sphere.NOISE_PHI * d.z_hat0() + d[0]) + d[1]
    assert torch.allclose(d.z_hat(2), z2)
