"""The port's forecast engine with ``EngineConfig.member_axes`` (the
members spread over ranks) against the JAX package's single-device
scored rollout on ``fcn3_smoke``.

Worlds run in spawned processes over gloo (``distributed.world.
run_world``); the rank bodies live in the JAX-free ``_torch_dist_workers``
and every rank checks that it imported no JAX.  Weights cross as numpy
arrays and the reference's noise and perturbation draws are injected.
Every case rolls 3 scored leads (chunks of 2 in the port, one of 3 in
the reference) and is held to the reference's dispatch bar
(``tests/test_kernel_dispatch.py:289``): each rank's block of the final
members at rtol 1e-4 / atol 1e-5, the noise coefficients and every score
at rtol 1e-4 / atol 1e-6.

Cases: E = 4 over 2 and 4 ranks, E = 3 over 2 (uneven blocks), E = 2
over 2 (a +/- pair straddles the ranks), obs perturbations on a
straddling pair and independent (not antithetic) ones on uneven blocks,
bred vectors with each rank breeding only its own draws and under the
ensemble transform (every rank breeds every draw), in-loop spectra, two
coalesced requests, a 2 x 2 mesh whose ``member_axes`` names both axes,
and a 2 x 2 x 1 mesh whose member group is two of its three axes (one
group per slice of the third).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_threads import few_torch_threads  # noqa: F401

import _torch_dist_workers as workers
from repro.configs import fcn3 as jcfgs
from repro.core.fcn3 import FCN3 as JFCN3
from repro.core.sphere import noise as jnoise
from repro.data import era5_synthetic as jdata
from repro.inference import engine as jengine
from repro.inference import perturbations as jpert
from repro.train import checkpoint as jckpt
from repro_torch.distributed.world import run_world
from repro_torch.inference.engine import EngineConfig
from repro_torch.serving.cache import ExecutableKey

STEPS, SALT, TIMEOUT = 3, 0x5EED, 240.0
OBS = dict(kind="obs", amplitude=0.05)
BRED = dict(kind="bred", amplitude=0.05, bred_cycles=1)
ROW = ((1, 2), ("data", "model"))
#: case -> (world size, mesh, member axes, members, engine options,
#: requests as (sample, key))
CASES = {
    "E4-R2": (2, ROW, ("model",), 4, {}, [(11, 7)]),
    "E3-R2": (2, ROW, ("model",), 3, {}, [(11, 7)]),
    "E2-R2-straddle": (2, ROW, ("model",), 2, {}, [(11, 7)]),
    "E2-R2-obs": (2, ROW, ("model",), 2, {"perturb": OBS}, [(12, 9)]),
    "E3-R2-obs-independent": (2, ROW, ("model",), 3,
                              {"perturb": dict(OBS, antithetic=False)},
                              [(12, 9)]),
    "E3-R2-bred": (2, ROW, ("model",), 3, {"perturb": BRED}, [(12, 9)]),
    "E4-R2-bred-transform": (2, ROW, ("model",), 4,
                             {"perturb": dict(BRED, ensemble_transform=True)},
                             [(12, 9)]),
    "E4-R2-spectra": (2, ROW, ("model",), 4, {"spectra": True}, [(11, 7)]),
    "E4-R2-coalesced": (2, ROW, ("model",), 4, {}, [(11, 3), (12, 5)]),
    "E4-R4": (4, ((1, 4), ("data", "model")), ("model",), 4, {},
              [(11, 7)]),
    "E4-mesh2x2": (4, ((2, 2), ("data", "model")), ("model", "data"), 4,
                   {}, [(11, 7)]),
    "E4-mesh2x2x1": (4, ((2, 2, 1), ("pod", "data", "model")),
                     ("model", "data"), 4, {}, [(11, 7)]),
}
SCORES = ("crps", "ens_rmse", "spread", "ssr", "rank_hist")


@pytest.fixture(scope="module")
def ref():
    """The JAX model, its params and the synthetic data, as numpy."""
    cfg = jcfgs.fcn3_smoke()
    model = JFCN3(cfg)
    ds = jdata.SyntheticERA5(cfg)
    params = model.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v)
            for k, v in jckpt._flatten_with_paths(params).items()}
    aux = np.stack([ds.aux_fields(6.0 * (n + 1)) for n in range(STEPS)])
    states = {s: np.stack([np.asarray(ds.state(s, n))
                           for n in range(STEPS + 1)]) for s in (11, 12)}
    return {"cfg": cfg, "model": model, "params": params, "flat": flat,
            "bufs": model.make_buffers(), "aux": aux, "states": states}


def _draws(ref, key, members, perturb):
    """The reference engine's draws for one request (as
    ``tests/test_torch_engine.py`` takes them)."""
    m = ref["model"]
    nb = m.noise.buffers()
    z0 = np.asarray(m.noise.init_state(key, (members,), nb))
    etas = [np.asarray(m.noise._sample_coeffs(
        jax.random.fold_in(key, n), (members,), nb["sigma_l"]))
        for n in range(STEPS)]
    coeffs = None
    if perturb.active:
        pert = jpert.InitialConditionPerturbation(
            m.in_sht, perturb, m.grid_in.area_weights_2d())
        k = (members + 1) // 2 if perturb.antithetic else members
        coeffs = np.asarray(jnoise.sample_spectral_coeffs(
            jax.random.fold_in(key, SALT), (k, ref["cfg"].n_state),
            pert.sigma_l,
            m.in_sht.lmax, m.in_sht.mmax))
    return {"z_hat0": z0, "etas": etas, "perturb": coeffs}


@pytest.fixture(scope="module")
def expected(ref):
    """Each case's requests: their inputs and draws, and the JAX
    single-device scored rollout of each (one engine per distinct
    configuration)."""
    engines, out = {}, {}
    for name, (_, _, _, members, opts, reqs) in CASES.items():
        pj = jpert.PerturbationConfig(**opts.get("perturb", {}))
        spectra = opts.get("spectra", False)
        ekey = (members, pj, spectra)
        if ekey not in engines:
            engines[ekey] = jengine.ForecastEngine(
                ref["model"], jengine.EngineConfig(
                    members=members, lead_chunk=STEPS, perturb=pj,
                    spectra=spectra))
        case = []
        for sample, seed in reqs:
            key = jax.random.PRNGKey(seed)
            s0, truth = ref["states"][sample][0], ref["states"][sample][1:]
            want = engines[ekey].forecast(
                ref["params"], ref["bufs"], jnp.asarray(s0),
                jnp.asarray(ref["aux"]), key, truth=jnp.asarray(truth))
            case.append({"state0": s0, "truth": truth,
                         **_draws(ref, key, members, pj),
                         "want": {"final_state": np.asarray(
                                      want.final_state),
                                  "final_noise": np.asarray(
                                      want.final_noise),
                                  "scores": {k: np.asarray(v) for k, v
                                             in want.scores.items()}}})
        out[name] = case
    return out


@pytest.fixture(scope="module")
def worlds(ref, expected):
    """Each world size's cases run in one world; results by case."""
    res = {}
    for size in sorted({c[0] for c in CASES.values()}):
        cases = {
            name: {"mesh": mesh, "axes": axes, "members": members, **opts,
                   "requests": [{k: v for k, v in r.items() if k != "want"}
                                for r in expected[name]]}
            for name, (n, mesh, axes, members, opts, _) in CASES.items()
            if n == size}
        setup = {"params": ref["flat"], "aux": ref["aux"], "cases": cases}
        ranks = run_world(workers.engine_rank, size, (setup,),
                          timeout=TIMEOUT, threads=1)
        assert not any(r["jax_loaded"] for r in ranks)
        for name in cases:
            res[name] = [r[name] for r in ranks]
    return res


def _close(got, want, rtol, atol, msg):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("case", list(CASES))
def test_matches_the_jax_single_device_rollout(case, expected, worlds):
    ranks = worlds[case]
    _, (shape, names), axes, members = CASES[case][:4]
    blocks = [r["block"] for r in ranks]
    # each member group's blocks tile the ensemble in rank order (here
    # every group is a run of consecutive ranks)
    size = int(np.prod([shape[names.index(a)] for a in axes]))
    for g in range(0, len(blocks), size):
        part = blocks[g:g + size]
        assert part[0][0] == 0 and part[-1][1] == members
        assert all(a[1] == b[0] and a[0] < a[1]
                   for a, b in zip(part, part[1:]))
    for q, (r, (lo, hi)) in enumerate(zip(ranks, blocks)):
        assert r["received"] > 0
        for i, (got, req) in enumerate(zip(r["results"], expected[case])):
            want = req["want"]
            at = f"{case} rank {q} request {i}"
            _close(got["final_state"], want["final_state"][lo:hi], 1e-4,
                   1e-5, at)
            _close(got["final_noise"], want["final_noise"], 1e-4, 1e-6, at)
            names = SCORES + (("spectrum", "spectrum_truth")
                              if CASES[case][4].get("spectra") else ())
            assert set(got["scores"]) == set(names)
            for name in names:
                _close(got["scores"][name], want["scores"][name], 1e-4,
                       1e-6, f"{at} {name}")


def test_every_rank_returns_the_same_scores(worlds):
    for case, ranks in worlds.items():
        for r in ranks[1:]:
            for got, first in zip(r["results"], ranks[0]["results"]):
                for name, v in got["scores"].items():
                    np.testing.assert_array_equal(
                        v, first["scores"][name], err_msg=f"{case} {name}")


def test_straddling_pairs_split_member_by_member(worlds):
    # whole pairs where there are enough of them; else one member a rank
    assert [r["block"] for r in worlds["E4-R2"]] == [(0, 2), (2, 4)]
    assert [r["block"] for r in worlds["E3-R2"]] == [(0, 2), (2, 3)]
    assert [r["block"] for r in worlds["E2-R2-straddle"]] == [(0, 1), (1, 2)]
    assert [r["block"] for r in worlds["E4-R4"]] == [(0, 1), (1, 2), (2, 3),
                                                     (3, 4)]
    # the member group of two of three axes: one per "pod" slice
    assert [r["block"] for r in worlds["E4-mesh2x2x1"]] == [(0, 2), (2, 4),
                                                            (0, 2), (2, 4)]


def test_member_groups_are_made_once(worlds):
    # a second engine on the same mesh and axes takes the first's group
    for case, ranks in worlds.items():
        assert all(r["same_group"] for r in ranks), case


def test_serving_key_carries_member_axes():
    class Eng:
        def __init__(self, cfg):
            self.cfg = cfg

    plain = EngineConfig(members=4)
    sharded = dataclasses.replace(plain, member_axes=("model",))
    keys = [ExecutableKey.for_engine("smoke", Eng(c), True, 2)
            for c in (plain, sharded)]
    assert keys[0] != keys[1] and keys[0].token() != keys[1].token()
    assert ("model",) in keys[1].engine


def test_member_axes_are_validated():
    with pytest.raises(ValueError, match="member_axes"):
        EngineConfig(member_axes="model")
    with pytest.raises(ValueError, match="member_axes"):
        EngineConfig(member_axes=())
