"""The port's forecast engine against the JAX package's on ``fcn3_smoke``:
the bf16 precision policy, coalesced (batched) rollouts with obs
perturbations and in-loop spectra, and bred-vector member init; then the
port's own staging, chunking and shrink invariants.

Weights cross over as numpy arrays; threefry draws cannot be reproduced
in torch, so the reference's noise and perturbation coefficients are
injected.  Bars: the reference's own (``tests/test_kernel_dispatch.py``,
``tests/test_inference_engine.py``): states rtol 1e-4 / atol 1e-5, scores
rtol 1e-4 / atol 1e-6, and a bf16 rollout within 0.15 of its reference.
Batched runs are held to these bars against serial ones, never bitwise:
the products run at another batch size.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import few_torch_threads  # noqa: F401

from repro.configs import fcn3 as jcfgs
from repro.core.fcn3 import FCN3 as JFCN3
from repro.core.sphere import noise as jnoise
from repro.data import era5_synthetic as jdata
from repro.inference import engine as jengine
from repro.inference import perturbations as jpert
from repro.train import checkpoint as jckpt
from repro_torch.configs import fcn3 as tcfgs
from repro_torch.core.fcn3 import FCN3 as TFCN3
from repro_torch.inference import params as tparams
from repro_torch.inference import perturbations as tpert
from repro_torch.inference.engine import (SCORE_NAMES, EngineConfig,
                                          ForecastEngine, InjectedNoise,
                                          members_noise)
from repro_torch.kernels.config import KernelConfig
from repro_torch.runtime import ProductDtypes

MEMBERS, STEPS, SAMPLES = 2, 3, (11, 12)
SALT = 0x5EED


def _port(layout: str = "kernel") -> TFCN3:
    cfg = dataclasses.replace(tcfgs.fcn3_smoke(),
                              kernels=KernelConfig(sht=layout, disco=layout))
    return TFCN3(cfg, device="cpu")


@pytest.fixture(scope="module")
def ref():
    """The JAX model, its params and the synthetic data, as numpy."""
    cfg = jcfgs.fcn3_smoke()
    model = JFCN3(cfg)
    ds = jdata.SyntheticERA5(cfg)
    params = model.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v)
            for k, v in jckpt._flatten_with_paths(params).items()}
    aux = np.stack([ds.aux_fields(6.0 * (n + 1)) for n in range(5)])
    states = {s: np.stack([np.asarray(ds.state(s, n)) for n in range(6)])
              for s in SAMPLES}
    return {"cfg": cfg, "model": model, "params": params, "flat": flat,
            "bufs": model.make_buffers(), "aux": aux, "states": states}


@pytest.fixture(scope="module")
def port(ref):
    model = _port()
    tparams.load_into(model, ref["flat"])
    return model, model.make_buffers()


def _draws(ref, key, members, perturb=None):
    """The reference engine's draws for one request: z_hat0, the etas of
    each lead and, under ``perturb``, the perturbations' coefficients."""
    m = ref["model"]
    nb = m.noise.buffers()
    z0 = np.asarray(m.noise.init_state(key, (members,), nb))
    etas = [np.asarray(m.noise._sample_coeffs(
        jax.random.fold_in(key, n), (members,), nb["sigma_l"]))
        for n in range(5)]
    coeffs = None
    if perturb is not None and perturb.active:
        pert = jpert.InitialConditionPerturbation(
            m.in_sht, perturb, m.grid_in.area_weights_2d())
        coeffs = np.asarray(jnoise.sample_spectral_coeffs(
            jax.random.fold_in(key, SALT),
            ((members + 1) // 2, ref["cfg"].n_state), pert.sigma_l,
            m.in_sht.lmax, m.in_sht.mmax))
    return InjectedNoise(z0, etas, coeffs)


def _inputs(cfg, seed=0, batch=2):
    r = np.random.default_rng(seed)
    state = r.standard_normal((batch, cfg.n_state, cfg.nlat, cfg.nlon))
    cond = r.standard_normal((batch, cfg.n_cond_in, cfg.nlat, cfg.nlon))
    return state.astype(np.float32), cond.astype(np.float32)


def _np(x):
    """A torch or JAX array as numpy, bf16 widened to fp32."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=msg)


class TestBf16Policy:
    @pytest.fixture(scope="class")
    def jax_step(self, ref):
        state, cond = _inputs(ref["cfg"])
        bf = jnp.bfloat16
        want = ref["model"].apply(
            jengine._cast_floats(ref["params"], bf),
            jengine._cast_floats(ref["bufs"], bf),
            jnp.asarray(state, bf), jnp.asarray(cond, bf))
        assert want.dtype == jnp.float32
        return state, cond, np.asarray(want)

    @pytest.mark.parametrize("layout", ["kernel", "reference"])
    def test_one_step_matches_jax(self, ref, jax_step, layout):
        # the step on the engine's prepared bf16 params and buffers,
        # before the carry cast: every product widened to fp32 as JAX
        # promotes, so it holds the fp32 bar
        state, cond, want = jax_step
        model = _port(layout)
        tparams.load_into(model, ref["flat"])
        eng = ForecastEngine(model, EngineConfig(compute_dtype="bfloat16"))
        params, bufs = eng._prepare_inputs(model.make_buffers())
        assert all(p.dtype == torch.bfloat16 for p in params.values())
        assert bufs["latent_sht"]["wpct"].dtype == torch.bfloat16
        with torch.inference_mode():
            got = eng._apply(params, bufs,
                             torch.from_numpy(state).bfloat16(),
                             torch.from_numpy(cond).bfloat16())
            fp32 = model(model.make_buffers(), torch.from_numpy(state),
                         torch.from_numpy(cond))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
        # the rounding is visible at this bar: the test can tell the two
        assert float((fp32 - got).abs().max()) > 1e-3

    def test_no_product_takes_a_bf16_operand(self, port):
        model, bufs = port
        eng = ForecastEngine(model, EngineConfig(members=MEMBERS,
                                                 compute_dtype="bfloat16"))
        with ProductDtypes() as seen:
            eng.forecast(bufs, torch.zeros(17, 33, 64),
                         np.zeros((1, 4, 33, 64), np.float32),
                         members_noise(model, 0))
        assert seen.counts
        assert not [k for k in seen.counts if "bfloat16" in k[1]], \
            seen.counts

    def test_reference_step_widens_every_product(self, ref):
        # the premise of the port's policy: the JAX step on bf16 params,
        # buffers and inputs takes no product with two bf16 operands (its
        # band and Legendre dispatch widen to fp32 and JAX promotes the
        # rest) and returns fp32; -s prints the tally
        bf = jnp.bfloat16
        state, cond = _inputs(ref["cfg"])
        closed = jax.make_jaxpr(ref["model"].apply)(
            jengine._cast_floats(ref["params"], bf),
            jengine._cast_floats(ref["bufs"], bf),
            jnp.asarray(state, bf), jnp.asarray(cond, bf))
        counts = collections.Counter()

        def walk(jaxpr):
            # every dot_general, sub-jaxprs included
            for eqn in jaxpr.eqns:
                if eqn.primitive.name == "dot_general":
                    counts[(tuple(str(v.aval.dtype) for v in eqn.invars),
                            str(eqn.outvars[0].aval.dtype))] += 1
                for val in eqn.params.values():
                    for sub in (val if isinstance(val, (list, tuple))
                                else [val]):
                        if hasattr(sub, "eqns"):
                            walk(sub)
                        elif hasattr(sub, "jaxpr"):
                            walk(sub.jaxpr)

        walk(closed.jaxpr)
        print("dot_generals of the JAX bf16 step:", dict(counts))
        assert counts[(("bfloat16", "float32"), "float32")] > 0
        for (ins, out), _ in counts.items():
            assert ins.count("bfloat16") < 2, (ins, out)
            assert out in ("float32", "complex64"), (ins, out)
        assert closed.out_avals[0].dtype == jnp.float32

    def test_rollout_within_bar_of_jax(self, ref, port):
        model, bufs = port
        key = jax.random.PRNGKey(7)
        s0, truth = ref["states"][11][0], ref["states"][11][1:STEPS + 1]
        cfg_j = jengine.EngineConfig(members=MEMBERS, lead_chunk=2,
                                     compute_dtype="bfloat16")
        want = jengine.ForecastEngine(ref["model"], cfg_j).forecast(
            ref["params"], ref["bufs"], jnp.asarray(s0),
            jnp.asarray(ref["aux"][:STEPS]), key, truth=jnp.asarray(truth))
        eng = ForecastEngine(model, EngineConfig(
            members=MEMBERS, lead_chunk=2, compute_dtype="bfloat16"))
        got = eng.forecast(bufs, s0, ref["aux"][:STEPS],
                           _draws(ref, key, MEMBERS), truth=truth)
        assert got.final_state.dtype == torch.bfloat16
        err = np.abs(_np(got.final_state) - _np(want.final_state))
        assert err.max() < 0.15
        for name, v in got.scores.items():
            assert v.dtype == torch.float32 and bool(torch.isfinite(v).all())
            assert v.shape == tuple(want.scores[name].shape), name


class TestBatched:
    PERTURB = dict(kind="obs", amplitude=0.05)

    @pytest.fixture(scope="class")
    def runs(self, ref, port):
        """Two requests (other samples and keys, one shared aux callable)
        through JAX's ``forecast_batched``, the port's, and the port's
        serial ``forecast`` of each."""
        model, bufs = port
        keys = [jax.random.PRNGKey(3), jax.random.PRNGKey(5)]
        aux_fn = (lambda n: ref["aux"][n])
        s0s = [ref["states"][s][0] for s in SAMPLES]
        truths = [ref["states"][s][1:STEPS + 1] for s in SAMPLES]
        pj = jpert.PerturbationConfig(**self.PERTURB)
        eng_j = jengine.ForecastEngine(ref["model"], jengine.EngineConfig(
            members=MEMBERS, lead_chunk=2, perturb=pj, spectra=True))
        want = eng_j.forecast_batched(
            ref["params"], ref["bufs"], [jnp.asarray(s) for s in s0s],
            [aux_fn, aux_fn], keys, steps=STEPS,
            truths=[jnp.asarray(t) for t in truths])
        eng = ForecastEngine(model, EngineConfig(
            members=MEMBERS, lead_chunk=2, spectra=True,
            perturb=tpert.PerturbationConfig(**self.PERTURB)))
        noises = [_draws(ref, k, MEMBERS, pj) for k in keys]
        got = eng.forecast_batched(bufs, s0s, [aux_fn, aux_fn], noises,
                                   steps=STEPS, truths=truths)
        serial = [eng.forecast(bufs, s0, aux_fn, nz, steps=STEPS, truth=t)
                  for s0, nz, t in zip(s0s, noises, truths)]
        return want, got, serial

    @pytest.mark.parametrize("against", ["jax", "serial"])
    def test_final_state(self, runs, against):
        want, got, serial = runs
        ref_runs = want if against == "jax" else serial
        for r, (g, w) in enumerate(zip(got, ref_runs)):
            assert tuple(g.final_state.shape) == (MEMBERS, 17, 33, 64)
            _close(g.final_state, w.final_state, 1e-4, 1e-5, f"request {r}")
            _close(g.final_noise, w.final_noise, 1e-4, 1e-6)

    @pytest.mark.parametrize("against", ["jax", "serial"])
    @pytest.mark.parametrize("name", ["crps", "ens_rmse", "spread", "ssr",
                                      "rank_hist", "spectrum",
                                      "spectrum_truth"])
    def test_scores(self, runs, against, name):
        want, got, serial = runs
        ref_runs = want if against == "jax" else serial
        for r, (g, w) in enumerate(zip(got, ref_runs)):
            assert tuple(g.scores) == SCORE_NAMES
            if name.startswith("spectrum"):
                assert tuple(g.scores[name].shape) == (STEPS, 17, 33)
            # rank frequencies of nearly tied members: the state bar
            atol = 1e-5 if name == "rank_hist" else 1e-6
            _close(g.scores[name], w.scores[name], 1e-4, atol,
                   f"{name} request {r}")

    def test_requests_differ(self, runs):
        _, got, _ = runs
        assert float((got[0].final_state - got[1].final_state).abs().max()) \
            > 0.1


class TestBredInit:
    def test_members_match_jax(self, ref, port):
        model, bufs = port
        pcfg = dict(kind="bred", bred_cycles=2, ensemble_transform=True)
        key = jax.random.PRNGKey(13)
        s0 = ref["states"][11][0]
        eng_j = jengine.ForecastEngine(ref["model"], jengine.EngineConfig(
            members=4, perturb=jpert.PerturbationConfig(**pcfg)))
        want, _ = eng_j.init_carry(jnp.asarray(s0), key, ref["params"],
                                   ref["bufs"], jnp.asarray(ref["aux"][0]))
        eng = ForecastEngine(model, EngineConfig(
            members=4, perturb=tpert.PerturbationConfig(**pcfg)))
        with torch.inference_mode():
            got, _ = eng.init_carry(
                s0, _draws(ref, key, 4, jpert.PerturbationConfig(**pcfg)),
                bufs, torch.from_numpy(ref["aux"][0]))
        _close(got, want, 1e-4, 1e-5)
        np.testing.assert_allclose((got[0::2] + got[1::2]).numpy() / 2,
                                   np.broadcast_to(s0, (2,) + s0.shape),
                                   rtol=0, atol=1e-5)


def _forecast(eng, port_bufs, ref, lead_chunk=None, steps=5, **kw):
    return eng.forecast(port_bufs, ref["states"][11][0], ref["aux"][:steps],
                        members_noise(eng.model, 3),
                        truth=ref["states"][11][1:steps + 1], **kw)


class TestStaging:
    def test_chunking_is_bitwise_neutral(self, ref, port):
        model, bufs = port
        engines = [ForecastEngine(model, EngineConfig(
            members=MEMBERS, lead_chunk=k)) for k in (1, 2, 5)]
        assert [e.chunk_lengths(5) for e in engines] == [[1], [2, 1], [5]]
        runs = [_forecast(e, bufs, ref) for e in engines]
        for other in runs[1:]:
            assert torch.equal(other.final_state, runs[0].final_state)
            for name in runs[0].scores:
                assert torch.equal(other.scores[name], runs[0].scores[name])

    def test_callable_and_array_staging_agree_bitwise(self, ref, port):
        model, bufs = port
        eng = ForecastEngine(model, EngineConfig(members=MEMBERS,
                                                 lead_chunk=2))
        a = _forecast(eng, bufs, ref, steps=3)
        b = eng.forecast(bufs, ref["states"][11][0],
                         lambda n: ref["aux"][n], members_noise(model, 3),
                         steps=3, truth=lambda n: ref["states"][11][n + 1])
        assert torch.equal(a.final_state, b.final_state)
        assert torch.equal(a.scores["crps"], b.scores["crps"])

    @pytest.mark.parametrize("kind", ["none", "bred"])
    def test_each_step_staged_once(self, ref, port, kind):
        model, bufs = port
        eng = ForecastEngine(model, EngineConfig(
            members=MEMBERS, lead_chunk=2,
            perturb=tpert.PerturbationConfig(kind=kind, bred_cycles=1)))
        calls = []

        def aux(n):
            calls.append(n)
            return ref["aux"][n]

        spans = []
        list(eng.stream(bufs, ref["states"][11][0], aux,
                        members_noise(model, 3), steps=5,
                        on_span=lambda *a: spans.append(a[3]["start"])))
        # bred init peeks chunk 0 for its aux fields: no second copy
        assert sorted(calls) == list(range(5))
        assert eng.dispatch_stats() == {"chunks": 3, "h2d_chunks": 3,
                                        "h2d_steps": 5, "shrinks": 0}
        assert sorted(spans) == [0, 2, 4]

    @pytest.mark.parametrize("shared", [True, False])
    def test_batched_staging_counts_distinct_sources(self, ref, port,
                                                     shared):
        model, bufs = port
        eng = ForecastEngine(model, EngineConfig(members=MEMBERS,
                                                 lead_chunk=2))
        fn = (lambda n: ref["aux"][n])
        auxs = [fn, fn] if shared else [fn, lambda n: ref["aux"][n]]
        eng.forecast_batched(bufs, [ref["states"][11][0]] * 2, auxs,
                             [members_noise(model, 1),
                              members_noise(model, 2)], steps=3)
        assert eng.dispatch_stats()["h2d_steps"] == (3 if shared else 6)
        assert eng.dispatch_stats()["h2d_chunks"] == 2


class TestShrinkAndStreams:
    def test_survivors_shrink_onto_the_live_request(self, ref, port):
        model, bufs = port
        eng = ForecastEngine(model, EngineConfig(members=MEMBERS,
                                                 lead_chunk=1))
        s0s = [ref["states"][s][0] for s in SAMPLES]
        truths = [ref["states"][s][1:4] for s in SAMPLES]
        polls = iter([[0, 1], [1], [1]])
        blocks = list(eng.stream_batched(
            bufs, s0s, [ref["aux"][:3]] * 2,
            [members_noise(model, 1), members_noise(model, 2)],
            truths=truths, survivors=lambda: next(polls)))
        assert eng.dispatch_stats()["shrinks"] == 1
        assert blocks[0][0] is not None and blocks[1][0] is None
        serial = eng.forecast(bufs, s0s[1], ref["aux"][:3],
                              members_noise(model, 2), truth=truths[1])
        _close(blocks[-1][1].final_state, serial.final_state, 1e-4, 1e-5)
        crps = torch.cat([b[1].scores["crps"] for b in blocks])
        _close(crps, serial.scores["crps"], 1e-4, 1e-6)

    def test_perturbations_leave_the_noise_stream(self, ref, port):
        model, bufs = port
        runs = {kind: ForecastEngine(model, EngineConfig(
            members=MEMBERS, lead_chunk=2,
            perturb=tpert.PerturbationConfig(kind=kind))).forecast(
                bufs, ref["states"][11][0], ref["aux"][:2],
                members_noise(model, 3)) for kind in ("none", "obs")}
        assert torch.equal(runs["none"].final_noise, runs["obs"].final_noise)
        # ... which is the noise process's own: initial draw, two updates
        nz, nb = members_noise(model, 3), model.noise_buffers()
        z = nz.initial(model, (MEMBERS,), nb)
        for n in range(2):
            z = model.noise.step_with(z, nz.eta(model, n, z, nb))
        assert torch.equal(runs["none"].final_noise, z)
        assert not torch.equal(runs["none"].final_state,
                               runs["obs"].final_state)

    def test_kernels_override_rebuilds_the_buffer_layout(self, ref, port):
        model, bufs = port
        cfg = dict(members=MEMBERS, lead_chunk=2)
        eng = ForecastEngine(model, EngineConfig(
            **cfg, kernels=KernelConfig("reference", "reference")))
        assert "psi" in eng._adapt_buffers(bufs)["enc"]
        assert eng._adapt_buffers(bufs) is eng._adapt_buffers(bufs)
        assert model.cfg.kernels.disco == "kernel"
        a = _forecast(eng, bufs, ref, steps=2)
        b = _forecast(ForecastEngine(model, EngineConfig(**cfg)), bufs, ref,
                      steps=2)
        _close(a.final_state, b.final_state, 1e-4, 1e-5)

    def test_diagnostics_stack_over_leads_and_chunks(self, ref, port):
        model, bufs = port
        eng = ForecastEngine(model, EngineConfig(members=MEMBERS,
                                                 lead_chunk=2),
                             diagnostics=lambda sf: {
                                 "max": sf.amax(dim=(0, 2, 3))})
        res = _forecast(eng, bufs, ref, steps=3)
        assert tuple(res.diagnostics["max"].shape) == (3, 17)
        assert torch.equal(res.diagnostics["max"][-1],
                           res.final_state.amax(dim=(0, 2, 3)))

    def test_mismatched_requests_refused(self, ref, port):
        model, bufs = port
        eng = ForecastEngine(model, EngineConfig(members=MEMBERS))
        with pytest.raises(ValueError, match="one entry per request"):
            eng.forecast_batched(bufs, [ref["states"][11][0]] * 2,
                                 [ref["aux"][:2]], [members_noise(model, 1)])
