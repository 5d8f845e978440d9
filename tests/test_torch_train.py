"""The port's training path against the JAX package on ``fcn3_smoke``.

Same weights (carried over as numpy arrays), same batch and the JAX
reference's own noise draws injected into the port.  Bars: loss and its
terms at 1e-4; gradients and their global norm at the grad-parity bar of
``tests/test_kernel_dispatch.py`` (rtol=2e-3, atol=2e-4); Adam on
identical gradients at 1e-6.  Checkpoints cross between the packages in
both directions.
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
from repro.optim import adam as jadam
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtr
from repro_torch.configs import fcn3 as tcfgs
from repro_torch.core.fcn3 import FCN3 as TFCN3
from repro_torch.data import era5_synthetic as tdata
from repro_torch.inference import params as tparams
from repro_torch.inference.engine import InjectedNoise
from repro_torch.optim import adam as tadam
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import trainer as ttr

E = 2


def _flat(tree) -> dict:
    return {k: np.asarray(v)
            for k, v in jckpt._flatten_with_paths(tree).items()}


@pytest.fixture(scope="module")
def ref():
    """JAX smoke model, its init params and training buffers."""
    cfg = jcfgs.fcn3_smoke()
    model = JFCN3(cfg)
    ds = jdata.SyntheticERA5(cfg)
    params = model.init(jax.random.PRNGKey(0))
    cw = jcfgs.channel_weights(cfg.n_levels)
    bufs = dict(model.make_buffers(),
                **jtr.EnsembleTrainer(model, jtr.TrainConfig(),
                                      cw).make_loss_buffers())
    return {"cfg": cfg, "model": model, "ds": ds, "params": params,
            "flat": _flat(params), "cw": cw, "bufs": bufs}


def _port(ref) -> TFCN3:
    model = TFCN3(tcfgs.fcn3_smoke(), device="cpu")
    tparams.load_into(model, ref["flat"])
    return model


def _batch(ref, rollout):
    jb = next(iter(jdata.Loader(ref["ds"], global_batch=1, rollout=rollout)))
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _draws(ref, key, shape, steps):
    """The JAX trainer's noise draws: z_hat0 and the AR(1) etas."""
    noise = ref["model"].noise
    nb = ref["bufs"]["noise"]
    z0 = noise.init_state(key, shape, nb)
    etas = [np.array(noise._sample_coeffs(jax.random.fold_in(key, n), shape,
                                          nb["sigma_l"]))
            for n in range(steps - 1)]
    return InjectedNoise(np.array(z0), etas)


class TestTrainStep:
    @pytest.fixture(scope="class", params=[
        (1, False, False), (2, True, True)],
        ids=["rollout1", "rollout2-fair-centered"])
    def steps(self, ref, request):
        rollout, fair, centered = request.param
        tcfg = dict(ensemble_size=E, rollout_steps=rollout, fair_crps=fair,
                    noise_centering=centered)
        jtrainer = jtr.EnsembleTrainer(ref["model"], jtr.TrainConfig(**tcfg),
                                       ref["cw"])
        jb, tb = _batch(ref, rollout)
        key = jax.random.PRNGKey(11)
        (jl, jaux), jg = jax.jit(jax.value_and_grad(
            jtrainer.rollout_loss, has_aux=True))(ref["params"], ref["bufs"],
                                                  jb, key)
        model = _port(ref)
        ttrainer = ttr.EnsembleTrainer(model, ttr.TrainConfig(**tcfg),
                                       ref["cw"])
        bufs = dict(model.make_buffers(), **ttrainer.make_loss_buffers())
        tl, taux, tg = ttrainer.loss_and_grads(
            bufs, tb, _draws(ref, key, (E, 1), rollout))
        return (jl, jaux, _flat(jg)), (tl, taux, tg), rollout

    def test_loss_and_terms_match_jax(self, steps):
        (jl, jaux, _), (tl, taux, _), rollout = steps
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
        assert set(taux) == set(jaux) == {
            f"{k}_{n}" for k in ("nodal", "spectral") for n in range(rollout)}
        for k in jaux:
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                       rtol=1e-4, err_msg=k)

    def test_gradients_match_jax(self, steps):
        (_, _, jg), (_, _, tg), _ = steps
        assert set(tg) == {k.replace("/", ".") for k in jg}
        for k, want in jg.items():
            np.testing.assert_allclose(tg[k.replace("/", ".")].numpy(), want,
                                       rtol=2e-3, atol=2e-4, err_msg=k)
        np.testing.assert_allclose(
            float(tadam.global_norm(tg)),
            float(jadam.global_norm({k: jnp.asarray(v)
                                     for k, v in jg.items()})),
            rtol=2e-3)

    def test_train_step_updates_in_place(self, ref):
        model = _port(ref)
        trainer = ttr.EnsembleTrainer(model, ttr.TrainConfig(lr=1e-3),
                                      ref["cw"])
        assert all(p.requires_grad for p in model.parameters())
        bufs = dict(model.make_buffers(), **trainer.make_loss_buffers())
        _, tb = _batch(ref, 1)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        state = trainer.optimizer.init(dict(model.named_parameters()))
        state, aux = trainer.train_step(
            bufs, state, tb, _draws(ref, jax.random.PRNGKey(2), (E, 1), 1))
        assert int(state["step"]) == 1
        assert np.isfinite(float(aux["loss"])) and float(aux["grad_norm"]) > 0
        moved = [k for k, p in model.named_parameters()
                 if not torch.equal(p.detach(), before[k])]
        assert len(moved) == len(before)


def test_eval_step_matches_jax(ref):
    jtrainer = jtr.EnsembleTrainer(ref["model"], jtr.TrainConfig(), ref["cw"])
    jb, tb = _batch(ref, 1)
    key = jax.random.PRNGKey(4)
    want = jax.jit(jtrainer.make_eval_step(ref["bufs"], n_members=3))(
        ref["params"], jb, key)
    model = _port(ref)
    trainer = ttr.EnsembleTrainer(model, ttr.TrainConfig(), ref["cw"])
    bufs = dict(model.make_buffers(), **trainer.make_loss_buffers())
    got = trainer.eval_step(bufs, tb, _draws(ref, key, (3, 1), 1),
                            n_members=3)
    for k in ("crps", "rmse_ens_mean"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)


def test_estimate_wdt_matches_jax(ref):
    r = np.random.default_rng(0)
    samples = r.standard_normal((2, 3, 4, 6, 8)).astype(np.float32)
    np.testing.assert_allclose(
        ttr.estimate_wdt(torch.from_numpy(samples)),
        jtr.estimate_wdt(jnp.asarray(samples)), rtol=1e-5)


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

def _adam_pair(**kw):
    jkw = dict(kw)
    tkw = dict(kw)
    if "halve_every" in kw:
        lr0, every = kw["lr"], jkw.pop("halve_every")
        tkw.pop("halve_every")
        jkw["lr"] = jadam.halving_schedule(lr0, every)
        tkw["lr"] = tadam.halving_schedule(lr0, every)
    return jadam.Adam(**jkw), tadam.Adam(**tkw)


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2),
    dict(lr=1e-2, halve_every=2, clip_norm=0.5, weight_decay=0.01)],
    ids=["constant", "halving-clip-decay"])
def test_adam_matches_jax_on_identical_gradients(kw):
    r = np.random.default_rng(3)
    shapes = {"w": (3, 4), "b": (4,), "blocks/0/x": (2, 5)}
    p0 = {k: r.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    jparams = {"w": jnp.asarray(p0["w"]), "b": jnp.asarray(p0["b"]),
               "blocks": [{"x": jnp.asarray(p0["blocks/0/x"])}]}
    tparams_ = tparams.params_from_numpy(p0)
    jopt, topt = _adam_pair(**kw)
    jstate, tstate = jopt.init(jparams), topt.init(tparams_)
    for step in range(5):
        g = {k: (r.standard_normal(s) * 3.0 ** step).astype(np.float32)
             for k, s in shapes.items()}
        jg = {"w": jnp.asarray(g["w"]), "b": jnp.asarray(g["b"]),
              "blocks": [{"x": jnp.asarray(g["blocks/0/x"])}]}
        jparams, jstate = jopt.update(jparams, jg, jstate)
        tstate = topt.update(tparams_, tparams.params_from_numpy(g), tstate)
        want = _flat({"params": jparams, "opt_state": jstate})
        got = {f"params/{k}": v for k, v in
               tparams.params_to_numpy(tparams_).items()}
        got.update({f"opt_state/{k}": v for k, v in
                    tparams.opt_state_to_numpy(tstate).items()})
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step}: {k}")


def test_schedules_match_jax():
    steps = jnp.arange(12, dtype=jnp.int32)
    tsteps = torch.arange(12, dtype=torch.int32)
    for jsched, tsched in (
            (jadam.constant_schedule(3e-4), tadam.constant_schedule(3e-4)),
            (jadam.halving_schedule(4e-4, 3), tadam.halving_schedule(4e-4, 3)),
            (jadam.warmup_cosine_schedule(1e-3, 3, 10, 1e-5),
             tadam.warmup_cosine_schedule(1e-3, 3, 10, 1e-5))):
        want = np.asarray([float(jsched(s)) for s in steps])
        got = np.asarray([float(tsched(s)) for s in tsteps])
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_clip_by_global_norm_matches_jax():
    g = {"a": np.full((3,), 4.0, np.float32), "b": np.ones((2, 2), np.float32)}
    want = jadam.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()},
                                     1.0)
    got = tadam.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

class TestCheckpoint:
    def test_port_writes_jax_reads(self, ref, tmp_path):
        model = _port(ref)
        params = dict(model.named_parameters())
        opt = tadam.Adam(lr=1e-3)
        state = opt.update(params, {k: torch.ones_like(p)
                                    for k, p in params.items()},
                           opt.init(params))
        path = tckpt.save_checkpoint(str(tmp_path), 7, params, state,
                                     extra={"stage": "smoke"})
        assert tckpt.latest_checkpoint(str(tmp_path)) == path
        jopt = jadam.Adam(lr=1e-3)
        template = {"params": ref["params"],
                    "opt_state": jopt.init(ref["params"])}
        restored, manifest = jckpt.restore_checkpoint(path, template)
        assert manifest["step"] == 7 and manifest["extra"]["stage"] == "smoke"
        flat = _flat(restored)
        assert int(flat["opt_state/step"]) == 1
        for name, p in params.items():
            key = name.replace(".", "/")
            np.testing.assert_array_equal(flat[f"params/{key}"],
                                          p.detach().numpy())
            np.testing.assert_array_equal(flat[f"opt_state/mu/{key}"],
                                          state["mu"][name].numpy())
            np.testing.assert_array_equal(flat[f"opt_state/nu/{key}"],
                                          state["nu"][name].numpy())

    def test_jax_writes_port_reads(self, ref, tmp_path):
        jopt = jadam.Adam(lr=1e-3)
        grads = jax.tree.map(jnp.ones_like, ref["params"])
        jparams, jstate = jopt.update(ref["params"], grads,
                                      jopt.init(ref["params"]))
        path = jckpt.save_checkpoint(str(tmp_path), 3, jparams, jstate)
        params, state, manifest = tckpt.restore_checkpoint(path)
        assert manifest["step"] == 3
        want = _flat({"params": jparams, "opt_state": jstate})
        assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
        for name, t in params.items():
            key = name.replace(".", "/")
            np.testing.assert_array_equal(t.numpy(), want[f"params/{key}"])
            np.testing.assert_array_equal(state["mu"][name].numpy(),
                                          want[f"opt_state/mu/{key}"])
        model = _port(ref)
        tparams.load_into(model, tparams.params_to_numpy(params))
        assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# Data and configs
# ---------------------------------------------------------------------------

class TestData:
    @pytest.fixture(scope="class")
    def ds(self):
        return tdata.SyntheticERA5(tcfgs.fcn3_smoke(), device="cpu")

    def test_sample_pair_shapes_and_aux_match_jax(self, ds, ref):
        x0, targets, aux = ds.sample_pair(5, rollout=2)
        cfg = ds.cfg
        assert x0.shape == (cfg.n_state, cfg.nlat, cfg.nlon)
        assert targets.shape == (2, cfg.n_state, cfg.nlat, cfg.nlon)
        np.testing.assert_array_equal(aux.numpy(), np.asarray(
            ref["ds"].sample_pair(5, rollout=2)[2]))
        torch.testing.assert_close(targets[1], ds.state(5, 2))

    def test_sharded_loader_partitions_batch(self, ds):
        full = next(iter(tdata.Loader(ds, global_batch=4)))
        r0 = next(iter(tdata.Loader(ds, global_batch=4, rank=0, world=2)))
        r1 = next(iter(tdata.Loader(ds, global_batch=4, rank=1, world=2)))
        torch.testing.assert_close(full["state"][:2], r0["state"])
        torch.testing.assert_close(full["state"][2:], r1["state"])
        with pytest.raises(ValueError):
            tdata.Loader(ds, global_batch=3, world=2)

    def test_lat_sharded_loader_and_climatology(self, ds):
        b = next(iter(tdata.Loader(ds, global_batch=2, lat_shard=(1, 2))))
        h = ds.cfg.nlat
        assert b["state"].shape[-2] == h - h // 2
        assert b["aux"].shape[-2] == h - h // 2
        clim = tdata.climatology(ds, n=2)
        torch.testing.assert_close(clim, (ds.state(0) + ds.state(1)) / 2)


def test_variable_table_and_curriculum_match_jax():
    for n in (2, 13):
        assert tcfgs.channel_names(n) == jcfgs.channel_names(n)
        np.testing.assert_array_equal(tcfgs.channel_weights(n),
                                      jcfgs.channel_weights(n))
        assert tcfgs.water_channel_names(n) == jcfgs.water_channel_names(n)
    assert ([dataclasses.asdict(s) for s in tcfgs.FCN3_CURRICULUM]
            == [dataclasses.asdict(s) for s in jcfgs.FCN3_CURRICULUM])
