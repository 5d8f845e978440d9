"""The port's initial-condition perturbations, antithetic pairing, the
evaluation metrics beyond the engine's five scores and the surrogate's
spectral statistics, against the JAX package on the same numpy inputs.

The perturbations' threefry draws cannot be reproduced in torch, so the
reference's spectral coefficients are injected (``InjectedDraws``).
Bars: metrics and obs-error fields rtol 1e-5 / atol 1e-6; the ensemble
transform and bred vectors, whose Gram eigendecomposition and cycles sum
in another order, rtol 1e-4 / atol 1e-5.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import few_torch_threads  # noqa: F401

from repro.configs import fcn3 as jcfgs
from repro.core.sphere import grids as jgrids
from repro.core.sphere import noise as jnoise
from repro.core.sphere import sht as jsht
from repro.data import era5_synthetic as jdata
from repro.evaluation import metrics as jmetrics
from repro.inference import perturbations as jpert
from repro_torch.configs import fcn3 as tcfgs
from repro_torch.core.sphere import grids as tgrids
from repro_torch.core.sphere import noise as tnoise
from repro_torch.core.sphere import sht as tsht
from repro_torch.data import era5_synthetic as tdata
from repro_torch.evaluation import metrics as tmetrics
from repro_torch.inference import perturbations as tpert

NLAT, NLON, C = 16, 32, 3


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def fields():
    r = np.random.default_rng(21)
    ens = r.standard_normal((4, C, 33, 64)).astype(np.float32)
    truth = r.standard_normal((C, 33, 64)).astype(np.float32)
    clim = r.standard_normal((C, 33, 64)).astype(np.float32)
    aw = jgrids.make_grid(33, 64).area_weights_2d().astype(np.float32)
    wpct = jsht.SHT.create(jgrids.make_grid(33, 64)).buffers()["wpct"]
    return ens, truth, clim, aw, np.asarray(wpct)


class TestMetrics:
    @pytest.mark.parametrize("name", ["mae", "acc", "rank_histogram",
                                      "angular_psd", "ensemble_spectrum",
                                      "zonal_psd", "bias"])
    def test_matches_jax(self, fields, name):
        ens, truth, clim, aw, wpct = fields
        calls = {
            "mae": lambda m, t: m.mae(t(ens[0]), t(truth), t(aw)),
            "acc": lambda m, t: m.acc(t(ens[0]), t(truth), t(clim), t(aw)),
            "rank_histogram": lambda m, t: m.rank_histogram(
                t(ens), t(truth), t(aw)),
            "angular_psd": lambda m, t: m.angular_psd(t(truth), t(wpct)),
            "ensemble_spectrum": lambda m, t: m.ensemble_spectrum(
                t(ens), t(wpct)),
            "zonal_psd": lambda m, t: m.zonal_psd(t(ens), 7, 0.6),
            "bias": lambda m, t: m.bias(t(ens), t(truth)),
        }
        want = np.asarray(calls[name](jmetrics, jnp.asarray))
        got = calls[name](tmetrics, _t).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


class TestAntithetic:
    @pytest.mark.parametrize("members", [1, 2, 3, 6])
    def test_expand_exact(self, members):
        p = np.random.default_rng(members).standard_normal(
            ((members + 1) // 2, 2, 5)).astype(np.float32)
        want = np.asarray(jnoise.antithetic_expand(jnp.asarray(p), members))
        got = tnoise.antithetic_expand(_t(p), members).numpy()
        np.testing.assert_array_equal(got, want)

    def test_expand_refuses_wrong_draw_count(self):
        with pytest.raises(ValueError, match="need 2 draws"):
            tnoise.antithetic_expand(torch.zeros((3, 2)), 4)

    def test_center_noise_along_a_later_dim(self):
        z = np.random.default_rng(3).standard_normal(
            (2, 4, 3, 5)).astype(np.float32)
        want = np.asarray(jnoise.center_noise(jnp.asarray(z), axis=1))
        np.testing.assert_array_equal(
            tnoise.center_noise(_t(z), -3).numpy(), want)


class TestSyntheticStatistics:
    def test_spectrum_sigma_l_and_channel_std(self):
        ds_j = jdata.SyntheticERA5(jcfgs.fcn3_smoke())
        ds_t = tdata.SyntheticERA5(tcfgs.fcn3_smoke(), device="cpu")
        np.testing.assert_array_equal(ds_t.spectrum_sigma_l,
                                      ds_j.spectrum_sigma_l)
        # the port's states are its own draws: hold the statistic to its
        # definition on them
        x = np.stack([ds_t.state(i).numpy() for i in range(3)])
        np.testing.assert_allclose(ds_t.channel_std(3),
                                   x.std(axis=(0, 2, 3)), rtol=1e-5)


def _samplers(kind="obs", bred_cycles=2, transform=False, antithetic=True):
    """The same small-grid sampler in both packages (per-channel std)."""
    grid_j = jgrids.make_grid(NLAT, NLON, "gauss")
    grid_t = tgrids.make_grid(NLAT, NLON, "gauss")
    sigma_l = jnoise.power_law_sigma_l(NLAT, slope=1.0, peak_l=6)
    std = np.array([0.5, 1.0, 2.0], np.float32)
    kw = dict(kind=kind, amplitude=0.1, bred_cycles=bred_cycles,
              ensemble_transform=transform, antithetic=antithetic)
    pj = jpert.InitialConditionPerturbation(
        jsht.SHT.create(grid_j), jpert.PerturbationConfig(**kw),
        grid_j.area_weights_2d(), sigma_l=sigma_l, channel_std=std)
    pt = tpert.InitialConditionPerturbation(
        tsht.SHT.create(grid_t), tpert.PerturbationConfig(**kw),
        grid_t.area_weights_2d(), sigma_l=sigma_l, channel_std=std)
    return pj, pt


def _jax_coeffs(pj, key, k):
    """The reference's white coefficients of ``k`` draws."""
    return np.asarray(jnoise.sample_spectral_coeffs(
        key, (k, C), pj.sigma_l, pj.sht.lmax, pj.sht.mmax))


def _state0():
    return np.random.default_rng(8).standard_normal(
        (C, NLAT, NLON)).astype(np.float32)


def _step(lib, cat):
    """A cheap nonlinear stand-in for the model step, in either package."""
    def step(s):
        return s + 0.3 * lib.tanh(cat([s[..., 1:, :, :], s[..., :1, :, :]]))
    return step


def _jcat(xs):
    return jnp.concatenate(xs, axis=-3)


def _tcat(xs):
    return torch.cat(xs, dim=-3)


class TestSampler:
    def test_obs_vectors_and_members(self):
        pj, pt = _samplers("obs")
        key = jax.random.PRNGKey(4)
        coeffs = _jax_coeffs(pj, key, 3)
        want = np.asarray(pj.obs_vectors(key, 3, C))
        got = pt.obs_vectors(tpert.InjectedDraws(coeffs), 3, C).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        s0 = _state0()
        want = np.asarray(pj.members(key, jnp.asarray(s0), 6))
        got = pt.members(tpert.InjectedDraws(coeffs), _t(s0), 6).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        # each +/- pair centers exactly on the control
        np.testing.assert_allclose((got[0::2] + got[1::2]) / 2,
                                   np.broadcast_to(s0, got[0::2].shape),
                                   rtol=0, atol=1e-6)

    def test_orthogonalize(self):
        pj, pt = _samplers("bred", transform=True)
        p = np.random.default_rng(2).standard_normal(
            (3, C, NLAT, NLON)).astype(np.float32)
        want = np.asarray(pj.orthogonalize(jnp.asarray(p)))
        got = pt.orthogonalize(_t(p)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("transform", [False, True])
    def test_bred_vectors(self, transform):
        pj, pt = _samplers("bred", bred_cycles=2, transform=transform)
        key = jax.random.PRNGKey(9)
        coeffs = _jax_coeffs(pj, key, 2)
        s0 = _state0()
        want = np.asarray(pj.bred_vectors(key, jnp.asarray(s0),
                                          _step(jnp, _jcat), 2))
        got = pt.bred_vectors(tpert.InjectedDraws(coeffs), _t(s0),
                              _step(torch, _tcat), 2).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        want_m = np.asarray(pj.members(key, jnp.asarray(s0), 4,
                                       _step(jnp, _jcat)))
        got_m = pt.members(tpert.InjectedDraws(coeffs), _t(s0), 4,
                           _step(torch, _tcat)).numpy()
        np.testing.assert_allclose(got_m, want_m, rtol=1e-4, atol=1e-5)

    def test_generator_draws_hold_the_amplitude(self):
        _, pt = _samplers("obs")
        draws = tpert.GeneratorDraws(torch.Generator().manual_seed(1))
        p = pt.obs_vectors(draws, 64, C)
        got = p.std(dim=(0, 2, 3)).numpy()
        np.testing.assert_allclose(got, 0.1 * np.array([0.5, 1.0, 2.0]),
                                   rtol=0.25)

    def test_injected_draws_refuse_another_shape(self):
        _, pt = _samplers("obs")
        with pytest.raises(ValueError, match="caller wants"):
            pt.obs_vectors(tpert.InjectedDraws(
                np.zeros((2, C, NLAT, NLAT + 1), np.complex64)), 3, C)

    def test_bred_needs_a_step(self):
        _, pt = _samplers("bred")
        with pytest.raises(ValueError, match="step_fn"):
            pt.members(tpert.InjectedDraws(None), _t(_state0()), 2)


class TestConfig:
    def test_member_count_problems_match_the_reference(self):
        for members, centered, kind, transform in itertools.product(
                range(7), (True, False), ("none", "obs", "bred"),
                (False, True)):
            if transform and kind != "bred":
                continue
            for antithetic in (True, False):
                kw = dict(kind=kind, ensemble_transform=transform,
                          antithetic=antithetic)
                assert tpert.validate_member_count(
                    members, centered, tpert.PerturbationConfig(**kw)) == \
                    jpert.validate_member_count(
                        members, centered, jpert.PerturbationConfig(**kw)), \
                    (members, centered, kw)

    @pytest.mark.parametrize("kw, match", [
        (dict(kind="gauss"), "unknown perturbation kind"),
        (dict(kind="bred", bred_cycles=0), "bred_cycles"),
        (dict(kind="obs", ensemble_transform=True), "requires kind='bred'"),
    ])
    def test_bad_configs_refused_as_in_the_reference(self, kw, match):
        with pytest.raises(ValueError, match=match):
            jpert.PerturbationConfig(**kw)
        with pytest.raises(ValueError, match=match):
            tpert.PerturbationConfig(**kw)
