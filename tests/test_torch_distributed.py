"""The port's distribution (``repro_torch.distributed``, the trainer's
``member_axes``) against numpy emulations and the JAX package.

Each world runs in spawned processes with gloo over a ``FileStore`` in a
temporary directory (``repro_torch.distributed.world.run_world``: one
thread per rank, a join timeout of its own, the world killed on
timeout), from numpy-seeded inputs; the rank bodies live in the JAX-free
``_torch_dist_workers`` and every rank checks that it imported no JAX.

* ``compat``'s collectives and their gradients against a numpy
  emulation of JAX's tiled semantics (``psum``'s gradient is not
  multiplied by the number of ranks);
* Algorithms 1-3 on an (ens 2, lat 2, lon 2) world against the JAX
  single-device references at the JAX selftest's shapes and bars
  (``src/repro/distributed/selftest.py``: 1e-4, 1e-4 of max |ref|,
  1e-5);
* ``local_psi_blocks`` equal to JAX's, the masked bands covering the
  band, the sharding rules equal to JAX's ``PartitionSpec`` trees;
* ensemble-parallel training at ``fcn3_smoke`` on data 2 x model 2
  ranks with fair CRPS against the JAX trainer (injected draws; rtol
  2e-3 / atol 2e-4) and the port's single-process trainer, with equal
  parameters on every rank after one Adam step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import few_torch_threads  # noqa: F401
from jax.sharding import PartitionSpec

import _torch_dist_workers as workers
from repro.configs import archs as jarchs
from repro.configs import fcn3 as jcfgs
from repro.core import crps as jcrps
from repro.core.fcn3 import FCN3 as JFCN3
from repro.core.sphere import disco as jdisco
from repro.core.sphere import grids as jgrids
from repro.core.sphere import sht as jsht
from repro.data import era5_synthetic as jdata
from repro.distributed import dist_disco as jdist_disco
from repro.distributed import sharding as jsharding
from repro.kernels.config import KernelConfig as JKernelConfig
from repro.models.transformer import LM as JLM
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtr
from repro_torch.configs import archs as tarchs
from repro_torch.configs import fcn3 as tcfgs
from repro_torch.core.fcn3 import FCN3 as TFCN3
from repro_torch.core.sphere import disco as tdisco
from repro_torch.core.sphere import grids as tgrids
from repro_torch.distributed import dist_disco, sharding
from repro_torch.distributed.world import run_world
from repro_torch.inference import params as tparams
from repro_torch.inference.engine import InjectedNoise
from repro_torch.kernels.config import KernelConfig as TKernelConfig
from repro_torch.models.params import lm_params_to_numpy
from repro_torch.models.transformer import LM as TLM
from repro_torch.train import trainer as ttr

R = 2            # ranks along each mesh axis
TIMEOUT = 120.0


def _rng(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# ---------------------------------------------------------------------------
# numpy emulation of JAX's tiled collectives over R ranks
# ---------------------------------------------------------------------------

def _a2a(xs, split, concat):
    return [np.concatenate([np.split(x, R, axis=split)[q] for x in xs],
                           axis=concat) for q in range(R)]


def _inputs():
    x = _rng(0, (R, 4, 6, 8))
    z = (_rng(1, (R, 4, 6)) + 1j * _rng(2, (R, 4, 6))).astype(np.complex64)
    ins = {"x": x, "z": z}
    for name, (split, concat) in (("a2a_0_2", (0, 2)), ("a2a_2_0", (2, 0)),
                                  ("a2a_1_1", (1, 1))):
        shape = _a2a(list(x), split, concat)[0].shape
        ins[f"ct_{name}"] = _rng(3, (R,) + shape)
    ins["ct_rs"] = _rng(4, (R, 4, 3, 8))
    # Algorithms 1-3 at the JAX selftest's shapes
    ins["sht_x"] = _rng(10, (2, 8, 32, 64))
    t = jsht.SHT.create(jgrids.make_grid(32, 64, "gauss"), lmax=32, mmax=32)
    ins["sht_c"] = np.asarray(t.forward(jnp.asarray(ins["sht_x"])))
    ins["disco_x"] = _rng(11, (2, 8, 32, 64))
    ins["crps_ens"] = _rng(12, (4, 16 * 32))
    ins["crps_obs"] = _rng(13, (16 * 32,))
    ins["crps_w"] = jgrids.make_grid(16, 32, "gauss").area_weights_2d(
    ).astype(np.float32).reshape(-1)
    return ins


@pytest.fixture(scope="module")
def world8():
    """One world of 8 ranks: the collectives and Algorithms 1-3."""
    ins = _inputs()
    res = run_world(workers.selftest_rank, 8, (ins,), timeout=TIMEOUT,
                    threads=1)
    return ins, res


def _lon_pairs(res):
    """The results of ranks (0, 0, 0) and (0, 0, 1): one lon group."""
    by = {r["coord"]: r for r in res}
    return [by[(0, 0, q)]["collectives"] for q in range(R)]


def test_ranks_import_no_jax(world8):
    _, res = world8
    assert [r["jax_loaded"] for r in res] == [False] * 8


def test_axis_size_and_index(world8):
    _, res = world8
    for r in res:
        c = r["collectives"]
        assert c["size"] == {"ens": R, "lat": R, "lon": R}
        assert tuple(c["index"][a] for a in workers.AXES) == r["coord"]


@pytest.mark.parametrize("name,split,concat", [
    ("a2a_0_2", 0, 2), ("a2a_2_0", 2, 0), ("a2a_1_1", 1, 1)])
def test_all_to_all_and_its_gradient_are_tiled(world8, name, split, concat):
    ins, res = world8
    got = _lon_pairs(res)
    want = _a2a(list(ins["x"]), split, concat)
    # the gradient is the all-to-all with split and concat swapped
    want_g = _a2a(list(ins[f"ct_{name}"]), concat, split)
    for q in range(R):
        np.testing.assert_array_equal(got[q][name][0], want[q])
        np.testing.assert_array_equal(got[q][name][1], want_g[q])


def test_complex_all_to_all(world8):
    ins, res = world8
    got = _lon_pairs(res)
    want = _a2a(list(ins["z"]), 1, 0)
    for q in range(R):
        assert got[q]["a2a_complex"].dtype == np.complex64
        np.testing.assert_array_equal(got[q]["a2a_complex"], want[q])
        np.testing.assert_allclose(got[q]["psum_complex"], ins["z"].sum(0),
                                   rtol=1e-6)


def test_psum_scatter_and_its_gradient(world8):
    ins, res = world8
    got = _lon_pairs(res)
    for q in range(R):
        want = sum(np.split(x, R, axis=1)[q] for x in ins["x"])
        np.testing.assert_allclose(got[q]["psum_scatter"][0], want,
                                   rtol=1e-6)
        # its gradient gathers the cotangents (tiled all-gather)
        np.testing.assert_array_equal(got[q]["psum_scatter"][1],
                                      np.concatenate(list(ins["ct_rs"]), 1))


def test_psum_of_a_replicated_scalar_has_identity_gradient(world8):
    ins, res = world8
    got = _lon_pairs(res)
    total = float((ins["x"].astype(np.float64) ** 2).sum())
    for q in range(R):
        loss, grad = got[q]["psum"]
        np.testing.assert_allclose(loss, total, rtol=1e-6)
        # d/dx_q of sum_r |x_r|^2 is 2 x_q: not R times that
        np.testing.assert_allclose(grad, 2.0 * ins["x"][q], rtol=1e-6)


def _blocks(res, key):
    return {r["coord"]: r["algorithms"][key] for r in res}


def test_dist_sht_forward_matches_jax(world8):
    ins, res = world8
    want = ins["sht_c"]
    for (e, la, lo), got in _blocks(res, "sht_forward").items():
        m0 = lo * 16
        np.testing.assert_allclose(
            got, want[:, :, la * 16:(la + 1) * 16, m0:m0 + 16], atol=1e-4,
            rtol=0)


def test_dist_sht_inverse_matches_jax(world8):
    ins, res = world8
    t = jsht.SHT.create(jgrids.make_grid(32, 64, "gauss"), lmax=32, mmax=32)
    want = np.asarray(t.inverse(jnp.asarray(ins["sht_c"])))
    for (e, la, lo), got in _blocks(res, "sht_inverse").items():
        np.testing.assert_allclose(
            got, want[:, :, la * 16:(la + 1) * 16, lo * 32:(lo + 1) * 32],
            atol=1e-4, rtol=0)


@pytest.mark.parametrize("layout", ["band", "dense"])
def test_dist_disco_matches_jax(world8, layout):
    ins, res = world8
    g = jgrids.make_grid(32, 64, "equiangular")
    plan = jdisco.make_disco_plan(g, g, cutoff_factor=3.0)
    want = np.asarray(jdisco.disco_conv(
        jnp.asarray(ins["disco_x"]), jnp.asarray(plan.psi),
        jnp.asarray(plan.lat_idx), plan.stride))
    scale = max(float(np.abs(want).max()), 1.0)
    for (e, la, lo), got in _blocks(res, f"disco_{layout}").items():
        block = want[..., la * 16:(la + 1) * 16, lo * 32:(lo + 1) * 32]
        assert got.shape == block.shape
        assert float(np.abs(got - block).max()) < 1e-4 * scale


@pytest.mark.parametrize("fair", [False, True], ids=["biased", "fair"])
def test_dist_crps_matches_jax(world8, fair):
    ins, res = world8
    want = float(jnp.sum(jcrps.crps_ensemble(
        jnp.asarray(ins["crps_ens"]), jnp.asarray(ins["crps_obs"]), axis=0,
        fair=fair) * jnp.asarray(ins["crps_w"])))
    for got in _blocks(res, f"crps_{fair}").values():
        assert abs(got - want) < 1e-5 * max(abs(want), 1.0)


# ---------------------------------------------------------------------------
# per-rank DISCO filters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grids", [
    ((32, 64, "equiangular"), (32, 64, "equiangular")),
    ((32, 64, "equiangular"), (16, 32, "gauss"))], ids=["same", "stride2"])
def test_local_psi_blocks_equal_jax(grids):
    gi, go = grids
    want, wloc = jdist_disco.local_psi_blocks(
        jdisco.make_disco_plan(jgrids.make_grid(*gi), jgrids.make_grid(*go)),
        R)
    got, gloc = dist_disco.local_psi_blocks(
        tdisco.make_disco_plan(tgrids.make_grid(*gi), tgrids.make_grid(*go)),
        R)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gloc, wloc)


def test_local_band_buffers_split_the_band_by_input_row():
    g = tgrids.make_grid(32, 64, "equiangular")
    plan = tdisco.make_disco_plan(g, g, cutoff_factor=3.0)
    band, wrap_rows, psi_wrap = plan.banded_split()
    locs = [dist_disco.local_band_buffers(plan, r, R) for r in range(R)]
    # every tap lands on exactly one rank, in the band and the wrap rows
    np.testing.assert_array_equal(sum(b["psi_band"].numpy() for b in locs),
                                  band)
    np.testing.assert_array_equal(sum(b["psi_wrap"].numpy() for b in locs),
                                  psi_wrap)
    for r, b in enumerate(locs):
        lat = b["lat_idx"].numpy()
        assert lat.min() >= 0 and lat.max() < 16
        mine = (plan.lat_idx >= 16 * r) & (plan.lat_idx < 16 * (r + 1))
        np.testing.assert_array_equal(lat[mine], plan.lat_idx[mine] - 16 * r)
        assert not b["psi_band"].numpy()[:, ~mine].any()
        # the live taps are the masked band's: fewer than the full band's
        assert b["tap_ent"].shape[0] < plan.live_taps()["tap_ent"].shape[0]
        assert int(b["in_ptr"][-1]) == b["tap_ent"].shape[0]


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

def _jax_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}


@pytest.fixture(scope="module")
def fcn3_structs():
    jparams = jax.eval_shape(JFCN3(jcfgs.fcn3_smoke()).init,
                             jax.random.PRNGKey(0))
    return jparams, TFCN3(tcfgs.fcn3_smoke(), device="cpu")


@pytest.mark.parametrize("kw", [dict(), dict(mode="channel"),
                                dict(fsdp=True)],
                         ids=["domain", "channel", "fsdp"])
def test_fcn3_param_specs_match_jax(fcn3_structs, kw):
    jparams, tm = fcn3_structs
    want = _jax_specs(jsharding.fcn3_param_specs(jparams, **kw))
    got = sharding.fcn3_param_specs(dict(tm.named_parameters()), **kw)
    assert {k.replace(".", "/"): v for k, v in got.items()} == want


@pytest.mark.parametrize("layout", ["reference", "banded"])
def test_fcn3_buffer_specs_match_jax(layout):
    jk = (JKernelConfig() if layout == "reference"
          else JKernelConfig(sht="pallas", disco="pallas", interpret=True))
    tk = TKernelConfig(*(("reference",) * 2 if layout == "reference"
                         else ("kernel",) * 2))
    jb = JFCN3(dataclasses.replace(jcfgs.fcn3_smoke(),
                                   kernels=jk)).buffer_specs()
    tb = TFCN3(dataclasses.replace(tcfgs.fcn3_smoke(), kernels=tk),
               device="cpu").buffer_specs()
    want = _jax_specs(jsharding.fcn3_buffer_specs(jb))
    got = sharding.fcn3_buffer_specs(
        {f"{g}/{k}": v for g, bufs in tb.items() for k, v in bufs.items()})
    # the port's extra keys (live taps, extents) are replicated
    assert {k: got[k] for k in want} == want
    assert all(not any(got[k]) for k in set(got) - set(want))


def test_fcn3_batch_specs_match_jax():
    batch = {"state": np.zeros((2, 17, 33, 64)),
             "targets": np.zeros((2, 1, 17, 33, 64)), "step": np.zeros(())}
    for mode in ("domain", "channel"):
        assert sharding.fcn3_batch_specs(batch, ("data",), mode=mode) == \
            _jax_specs(jsharding.fcn3_batch_specs(batch, ("data",),
                                                  mode=mode))


def test_lm_param_specs_match_jax():
    jparams = JLM(jarchs.smoke_config("mamba2-130m")).init(
        jax.random.PRNGKey(0))
    jcfg = jarchs.smoke_config("mamba2-130m")
    want = _jax_specs(jsharding.lm_param_specs(jcfg, jparams))
    tcfg = tarchs.smoke_config("mamba2-130m")
    flat = {k: np.asarray(v)
            for k, v in jckpt._flatten_with_paths(jparams).items()}
    assert sharding.lm_param_specs(tcfg, flat) == want
    # the port's own parameters, mapped to the JAX tree's stacked layout
    port = lm_params_to_numpy(TLM(tcfg, device="cpu").state_dict(), tcfg)
    assert sharding.lm_param_specs(tcfg, port) == want


def test_sanitize_specs_and_placements():
    specs = {"emb": ("data", "model"), "b": ("model",)}
    structs = {"emb": np.zeros((51865, 64)), "b": np.zeros((6,))}
    sizes = {"data": 16, "model": 4}
    got = sharding.sanitize_specs(sizes, specs, structs)
    assert got == {"emb": (None, "model"), "b": (None,)}

    class Mesh:
        mesh_dim_names = ("data", "model")
    from torch.distributed.tensor import Replicate, Shard
    assert sharding.to_placements((None, "model"), Mesh()) == (Replicate(),
                                                              Shard(1))
    assert sharding.to_placements((("data", "model"), None), Mesh()) == (
        Shard(0), Shard(0))
    with pytest.raises(ValueError):
        sharding.to_placements(("model", "model"), Mesh())


@pytest.mark.parametrize("entry,want", [
    (None, (0, 1)), ("data", (1, 2)), ("model", (2, 3)),
    (("data", "model"), (5, 6)), (("model", "data"), (5, 6))])
def test_block_of_counts_the_named_axes_major_to_minor(entry, want):
    class Mesh:     # this rank: data 1 of 2, model 2 of 3
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return (2, 3)[i]

        def get_local_rank(self, axis):
            return {"data": 1, "model": 2}[axis]
    assert sharding.block_of(entry, Mesh()) == want


# ---------------------------------------------------------------------------
# ensemble-parallel training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    cfg = jcfgs.fcn3_smoke()
    model = JFCN3(cfg)
    params = model.init(jax.random.PRNGKey(0))
    cw = jcfgs.channel_weights(cfg.n_levels)
    bufs = dict(model.make_buffers(),
                **jtr.EnsembleTrainer(model, jtr.TrainConfig(),
                                      cw).make_loss_buffers())
    flat = {k: np.asarray(v)
            for k, v in jckpt._flatten_with_paths(params).items()}
    return {"model": model, "ds": jdata.SyntheticERA5(cfg),
            "params": params, "flat": flat, "cw": cw, "bufs": bufs}


@pytest.fixture(scope="module", params=[
    dict(ensemble_size=4, rollout_steps=1, fair_crps=True),
    dict(ensemble_size=2, rollout_steps=2, fair_crps=True,
         noise_centering=True)],
    ids=["E4-fair", "E2-fair-rollout2-centered"])
def trained(ref, request):
    """The 4-rank run, the JAX trainer and the port's single process on
    one global batch of 2 with the same draws."""
    tcfg = request.param
    e, steps = tcfg["ensemble_size"], tcfg["rollout_steps"]
    jb = next(iter(jdata.Loader(ref["ds"], global_batch=2, rollout=steps)))
    jb = {k: np.array(v) for k, v in jb.items()}
    key = jax.random.PRNGKey(7)
    noise = ref["model"].noise
    nb = ref["bufs"]["noise"]
    z0 = np.array(noise.init_state(key, (e, 2), nb))
    etas = [np.array(noise._sample_coeffs(jax.random.fold_in(key, n),
                                          (e, 2), nb["sigma_l"]))
            for n in range(steps - 1)]
    jtrainer = jtr.EnsembleTrainer(ref["model"], jtr.TrainConfig(**tcfg),
                                   ref["cw"])
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        jtrainer.rollout_loss, has_aux=True))(
        ref["params"], ref["bufs"], {k: jnp.asarray(v) for k, v in
                                     jb.items()}, key)
    jg = {k.replace("/", "."): np.asarray(v)
          for k, v in jckpt._flatten_with_paths(jg).items()}
    setup = {"params": ref["flat"], "cw": ref["cw"], "batch": jb,
             "z_hat0": z0, "etas": etas,
             "tcfg": dict(tcfg, member_axes=("model", "data"))}
    res = run_world(workers.train_rank, 4, (setup,), timeout=TIMEOUT,
                    threads=1)
    model = TFCN3(tcfgs.fcn3_smoke(), device="cpu")
    tparams.load_into(model, ref["flat"])
    single = ttr.EnsembleTrainer(model, ttr.TrainConfig(**tcfg), ref["cw"])
    sl, saux, sg = single.loss_and_grads(
        dict(model.make_buffers(), **single.make_loss_buffers()),
        {k: torch.from_numpy(v) for k, v in jb.items()},
        InjectedNoise(z0, etas))
    return {"jax": (float(jl), {k: float(v) for k, v in jaux.items()}, jg),
            "single": (float(sl), {k: float(v) for k, v in saux.items()},
                       {k: v.numpy() for k, v in sg.items()}),
            "ranks": res, "init": ref["flat"]}


def test_train_ranks_import_no_jax(trained):
    assert not any(r["jax_loaded"] for r in trained["ranks"])


def test_loss_and_terms_match_jax_and_single_process(trained):
    jl, jaux, _ = trained["jax"]
    sl, saux, _ = trained["single"]
    for r in trained["ranks"]:
        np.testing.assert_allclose(r["loss"], jl, rtol=1e-4)
        np.testing.assert_allclose(r["loss"], sl, rtol=1e-5)
        assert set(r["aux"]) == set(jaux)
        for k in jaux:
            np.testing.assert_allclose(r["aux"][k], jaux[k], rtol=1e-4,
                                       err_msg=k)
            np.testing.assert_allclose(r["aux"][k], saux[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def test_gradients_match_jax_and_single_process(trained):
    _, _, jg = trained["jax"]
    _, _, sg = trained["single"]
    for r in trained["ranks"]:
        assert set(r["grads"]) == set(jg)
        for k, want in jg.items():
            np.testing.assert_allclose(r["grads"][k], want, rtol=2e-3,
                                       atol=2e-4, err_msg=k)
            np.testing.assert_allclose(r["grads"][k], sg[k], rtol=2e-3,
                                       atol=2e-4, err_msg=k)


def test_every_rank_holds_the_same_gradients_and_parameters(trained):
    r0, *rest = trained["ranks"]
    for r in rest:
        for k in r0["grads"]:
            np.testing.assert_array_equal(r["grads"][k], r0["grads"][k])
            # after the broadcast and one Adam step on the reduced grads
            np.testing.assert_array_equal(r["params"][k], r0["params"][k])
    # the step moved every parameter off the (rank 0's) start
    init = trained["init"]
    assert not [k for k, v in r0["params"].items()
                if np.array_equal(v, init[k.replace(".", "/")])]


def test_launcher_trains_on_a_mesh_in_a_world_of_two():
    argv = ["--config", "smoke", "--device", "cpu", "--steps", "2",
            "--fcn3-sharding", "ensemble", "--mesh-model", "2",
            "--dist-backend", "gloo"]
    hist = run_world(workers.launcher_rank, 2, (argv,), timeout=TIMEOUT,
                     threads=1)
    assert [len(h) for h in hist] == [2, 2]
    for a, b in zip(*hist):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
        assert np.isfinite(a["loss"]) and a["grad_norm"] > 0
        assert 0 < a["collective_s"] < a["seconds"]


def test_launcher_trains_on_a_data_mesh_in_a_world_of_two():
    # each data rank loads its sample of the batch; the loss is the batch's
    argv = ["--config", "smoke", "--device", "cpu", "--steps", "1",
            "--batch", "2", "--mesh-data", "2", "--dist-backend", "gloo"]
    hist = run_world(workers.launcher_rank, 2, (argv,), timeout=TIMEOUT,
                     threads=1)
    (a,), (b,) = hist
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    assert np.isfinite(a["loss"]) and 0 < a["collective_s"] < a["seconds"]


def test_selftest_runs_on_the_card_unless_asked_for_cpu(monkeypatch):
    from repro_torch.distributed import selftest
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (selftest.run, lambda: selftest.main([])):
        with pytest.raises(RuntimeError, match="--device cpu"):
            call()


def test_member_axes_need_a_mesh():
    model = TFCN3(tcfgs.fcn3_smoke(), device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        ttr.EnsembleTrainer(model, ttr.TrainConfig(member_axes=("model",)),
                            jcfgs.channel_weights(2))


def test_local_filters_refuse_rows_that_do_not_split():
    # the encoder's odd row count cannot split over 2 latitude ranks
    # (721 at fcn3_full, 33 here), as in the JAX package
    gi = tgrids.make_grid(33, 64, "equiangular")
    plan = tdisco.make_disco_plan(gi, tgrids.make_grid(16, 32, "gauss"))
    with pytest.raises(AssertionError):
        dist_disco.local_psi_blocks(plan, R)
    with pytest.raises(AssertionError):
        dist_disco.local_band_buffers(plan, 0, R)
