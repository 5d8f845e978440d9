"""The port's FCN3 step, calibration and scored ensemble rollout against
the JAX package on ``fcn3_smoke``, from the same weights and inputs.

Weights cross over as numpy arrays keyed by JAX tree path; the rollout
replays the reference's noise draws (threefry streams cannot be
reproduced in torch).  Bars are the reference's own acceptance bars
(``tests/test_kernel_dispatch.py``): one step and the final rollout state
at rtol=1e-4, atol=1e-5; scores at rtol=1e-4, atol=1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import few_torch_threads  # noqa: F401

from repro.configs import fcn3 as jcfgs
from repro.core.fcn3 import FCN3 as JFCN3
from repro.data import era5_synthetic as jdata
from repro.inference import EngineConfig as JEngineConfig
from repro.inference import ForecastEngine as JForecastEngine
from repro.train import checkpoint as jckpt
from repro_torch.configs import fcn3 as tcfgs
from repro_torch.core.fcn3 import FCN3 as TFCN3
from repro_torch.data import era5_synthetic as tdata
from repro_torch.inference import params as tparams
from repro_torch.inference.engine import (SCORE_NAMES, EngineConfig,
                                          ForecastEngine, InjectedNoise)
from repro_torch.kernels.config import KernelConfig

CAL_ROUNDS = 2
STEPS = 3
MEMBERS = 2


def _flat(params) -> dict:
    return {k: np.asarray(v)
            for k, v in jckpt._flatten_with_paths(params).items()}


def _port(layout: str = "kernel") -> TFCN3:
    cfg = dataclasses.replace(tcfgs.fcn3_smoke(),
                              kernels=KernelConfig(sht=layout, disco=layout))
    return TFCN3(cfg, device="cpu")


@pytest.fixture(scope="module")
def ref():
    """JAX model, its init and calibrated params, and calibration inputs."""
    cfg = jcfgs.fcn3_smoke()
    model = JFCN3(cfg)
    ds = jdata.SyntheticERA5(cfg)
    bufs = model.make_buffers()
    state = ds.state(0)[None]
    cond = jnp.concatenate(
        [jnp.asarray(ds.aux_fields(0.0))[None],
         model.sample_noise(jax.random.PRNGKey(1), (1,))], axis=1)
    key = jax.random.PRNGKey(0)
    init = model.init(key)
    cal = model.init_calibrated(key, state, cond, bufs, rounds=CAL_ROUNDS)
    return {"cfg": cfg, "model": model, "ds": ds, "bufs": bufs,
            "state": np.asarray(state), "cond": np.asarray(cond),
            "init": _flat(init), "cal": cal, "cal_flat": _flat(cal)}


def _inputs(cfg, seed=0, batch=2):
    r = np.random.default_rng(seed)
    state = r.standard_normal((batch, cfg.n_state, cfg.nlat, cfg.nlon))
    cond = r.standard_normal((batch, cfg.n_cond_in, cfg.nlat, cfg.nlon))
    return state.astype(np.float32), cond.astype(np.float32)


class TestParams:
    def test_names_and_shapes_match_jax_init(self, ref):
        model = _port()
        own = {k: tuple(p.shape) for k, p in model.named_parameters()}
        want = {k: v.shape for k, v in
                tparams.params_from_numpy(ref["init"]).items()}
        assert own == want

    def test_port_init_draws_every_parameter(self):
        model = _port()
        model.init(torch.Generator().manual_seed(0))
        w = model.blocks[1].conv.weight
        fan_in = w.shape[1] * w.shape[2]
        assert abs(float(w.std()) / np.sqrt(2.0 / fan_in) - 1.0) < 0.1
        assert float(model.enc_atmos.bias.abs().max()) == 0.0
        np.testing.assert_array_equal(model.blocks[0].layer_scale.numpy(),
                                      1e-3 * np.ones(34, np.float32))

    def test_checkpoint_npz_loads(self, ref, tmp_path):
        path = jckpt.save_checkpoint(str(tmp_path), 3, ref["cal"])
        flat = tparams.load_arrays_npz(path)
        assert set(flat) == set(ref["cal_flat"])
        model = _port()
        tparams.load_into(model, flat)
        for name, p in model.named_parameters():
            np.testing.assert_array_equal(
                p.numpy(), ref["cal_flat"][name.replace(".", "/")])

    def test_load_refuses_missing_names(self, ref):
        flat = dict(ref["init"])
        flat.pop("blocks/1/mlp/w1")
        with pytest.raises(KeyError, match="blocks.1.mlp.w1"):
            tparams.load_into(_port(), flat)


class TestStep:
    @pytest.mark.parametrize("layout", ["kernel", "reference"])
    def test_apply_matches_jax(self, ref, layout):
        model = _port(layout)
        tparams.load_into(model, ref["cal_flat"])
        bufs = model.make_buffers()
        assert ("psi_band" in bufs["enc"]) == (layout == "kernel")
        state, cond = _inputs(ref["cfg"])
        want = ref["model"].apply(ref["cal"], ref["bufs"],
                                  jnp.asarray(state), jnp.asarray(cond))
        with torch.inference_mode():
            got = model(bufs, torch.from_numpy(state), torch.from_numpy(cond))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


class TestCalibration:
    def test_calibrate_from_jax_init_matches(self, ref):
        model = _port()
        tparams.load_into(model, ref["init"])
        model.calibrate(torch.from_numpy(ref["state"]),
                        torch.from_numpy(ref["cond"]), rounds=CAL_ROUNDS)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(
                p.numpy(), ref["cal_flat"][name.replace(".", "/")],
                rtol=1e-4, atol=1e-7, err_msg=name)


class TestRollout:
    @pytest.fixture(scope="class")
    def rollouts(self, ref):
        model_j, ds = ref["model"], ref["ds"]
        key = jax.random.PRNGKey(7)
        aux = np.stack([ds.aux_fields(6.0 * (n + 1)) for n in range(STEPS)])
        truth = np.stack([np.asarray(ds.state(0, n + 1))
                          for n in range(STEPS)])
        state0 = np.asarray(ds.state(0))
        eng_j = JForecastEngine(model_j, JEngineConfig(members=MEMBERS,
                                                       lead_chunk=2))
        want = eng_j.forecast(ref["cal"], ref["bufs"], jnp.asarray(state0),
                              jnp.asarray(aux), key, truth=jnp.asarray(truth))
        # the reference's own noise draws, replayed into the port
        nb = model_j.noise.buffers()
        z0 = model_j.noise.init_state(key, (MEMBERS,), nb)
        etas = [np.asarray(model_j.noise._sample_coeffs(
            jax.random.fold_in(key, n), (MEMBERS,), nb["sigma_l"]))
            for n in range(STEPS)]
        model_t = _port()
        tparams.load_into(model_t, ref["cal_flat"])
        eng_t = ForecastEngine(model_t, EngineConfig(members=MEMBERS,
                                                     lead_chunk=2))
        got = eng_t.forecast(model_t.make_buffers(), torch.from_numpy(state0),
                             torch.from_numpy(aux),
                             InjectedNoise(np.asarray(z0), etas),
                             truth=torch.from_numpy(truth))
        return want, got

    def test_final_state(self, rollouts):
        want, got = rollouts
        np.testing.assert_allclose(got.final_state.numpy(),
                                   np.asarray(want.final_state),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got.final_noise.numpy(),
                                   np.asarray(want.final_noise),
                                   rtol=1e-4, atol=1e-6)

    @pytest.mark.parametrize("name", ["crps", "ens_rmse", "spread", "ssr"])
    def test_scores(self, rollouts, name):
        want, got = rollouts
        assert got.scores[name].shape == (STEPS, 17)
        np.testing.assert_allclose(got.scores[name].numpy(),
                                   np.asarray(want.scores[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)

    def test_rank_histogram(self, rollouts):
        # ranks are comparisons of nearly tied members; hold the weighted
        # frequencies to the state bar and their sums exactly to one
        want, got = rollouts
        rh = got.scores["rank_hist"].numpy()
        assert rh.shape == (STEPS, 17, MEMBERS + 1)
        np.testing.assert_allclose(rh.sum(-1), 1.0, rtol=1e-5)
        np.testing.assert_allclose(rh, np.asarray(want.scores["rank_hist"]),
                                   rtol=1e-4, atol=1e-5)
        # the spectra are opt-in (EngineConfig.spectra)
        assert tuple(got.scores) == SCORE_NAMES[:5]


class TestSyntheticData:
    def test_aux_fields_match_and_state_is_sane(self, ref):
        cfg = tcfgs.fcn3_smoke()
        ds = tdata.SyntheticERA5(cfg, device="cpu")
        np.testing.assert_array_equal(ds.aux_fields(18.0).numpy(),
                                      ref["ds"].aux_fields(18.0))
        s0, s1 = ds.state(4, 0), ds.state(4, 1)
        assert s0.shape == (cfg.n_state, cfg.nlat, cfg.nlon)
        assert torch.isfinite(s1).all()
        np.testing.assert_array_equal(ds.state(4, 0).numpy(), s0.numpy())
        water = torch.from_numpy(cfg.water_channel_indices())
        assert float(s0[water].min()) > 0.0
        # AR(1) persistence between consecutive 6-hour offsets
        corr = np.corrcoef(s0.numpy().ravel(), s1.numpy().ravel())[0, 1]
        assert corr > 0.8


class TestBufferSpecs:
    """``FCN3.buffer_specs`` and the trainer's ``loss_buffer_specs``
    against the JAX package's ``ShapeDtypeStruct`` trees and the port's
    own buffers."""

    @staticmethod
    def _same(specs, bufs, want):
        for k, w in want.items():
            if isinstance(w, dict):
                TestBufferSpecs._same(specs[k], bufs[k], w)
                continue
            assert specs[k].device.type == "meta", k
            assert tuple(specs[k].shape) == w.shape, k
            if k != "wrap_rows":   # int64 index tensors in the port
                assert str(specs[k].dtype).split(".")[-1] == str(
                    np.dtype(w.dtype)), k
        assert set(specs) == set(bufs)
        for k, b in bufs.items():
            if isinstance(b, dict):
                continue
            assert (specs[k].shape, specs[k].dtype) == (b.shape, b.dtype), k

    @pytest.mark.parametrize("layout", ["reference", "kernel"])
    def test_model_buffer_specs(self, layout):
        from repro.kernels.config import KernelConfig as JKC
        jk = (JKC() if layout == "reference"
              else JKC(sht="pallas", disco="pallas", interpret=True))
        want = JFCN3(dataclasses.replace(jcfgs.fcn3_smoke(),
                                         kernels=jk)).buffer_specs()
        model = _port(layout)
        self._same(model.buffer_specs(), model.make_buffers(), want)

    def test_loss_buffer_specs(self):
        from repro.train import trainer as jtr
        from repro_torch.train import trainer as ttr
        cw = jcfgs.channel_weights(2)
        want = jtr.EnsembleTrainer(JFCN3(jcfgs.fcn3_smoke()),
                                   jtr.TrainConfig(), cw).loss_buffer_specs()
        tr = ttr.EnsembleTrainer(_port(), ttr.TrainConfig(), cw)
        specs, bufs = tr.loss_buffer_specs(), tr.make_loss_buffers()
        # the port's noise buffers hold what its noise process reads
        want["noise"] = {k: v for k, v in want["noise"].items()
                         if k in bufs["noise"]}
        self._same(specs, bufs, want)
