"""Channel parallelism (``repro_torch.distributed.channel``, the trainer's
``placement="channel"``, ``launch/train.py --fcn3-sharding channel``) and
the applied placement rules (``distributed/sharding.py``) against the
JAX package.

* The port's sanitized channel specs against JAX's ``sanitize_specs(mesh,
  fcn3_param_specs(mode="channel"), params)`` at ``fcn3_smoke`` and
  ``fcn3_full``, on meshes {data 1, model 2} and {2, 2} (a stub with
  ``axis_names`` and ``devices`` serves as JAX's mesh; ``fcn3_full``'s
  shapes need the modules, not the geometry plans, which are stubbed).
* One ``fcn3_smoke`` channel step on 2 and on 4 ranks (gloo worlds; rank
  bodies in ``tests/_torch_dist_workers.py``) against the JAX trainer's
  and one process's loss (rtol 1e-5) and gradients (rtol 2e-3, atol
  2e-4), with the same draws; each rank's blocks are the slices of the
  gathered leaves, and the checkpoint rank 0 writes whole reloads in one
  process bit for bit.
* Ensemble parallelism with 3 members on 2 model ranks: the members whole
  on each rank, held to one process.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import few_torch_threads  # noqa: F401

import _torch_dist_workers as workers
from repro.configs import fcn3 as jcfgs
from repro.core import fcn3 as jfcn3
from repro.data import era5_synthetic as jdata
from repro.distributed import sharding as jsharding
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtr
from repro_torch.configs import fcn3 as tcfgs
from repro_torch.core import fcn3 as tfcn3
from repro_torch.distributed import channel, sharding
from repro_torch.distributed.world import run_world
from repro_torch.inference import params as tparams
from repro_torch.inference.engine import InjectedNoise
from repro_torch.launch import counting
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import trainer as ttr

TIMEOUT = 180.0
MESHES = ((1, 2), (2, 2))
#: fcn3_full in channel mode on a model axis of 2: the ten MLPs' w1, b1,
#: w2 (the 641 latent channels, a prime, keep the conv weights whole)
FULL_SPLIT_LEAVES = 30
FULL_SPLIT_PARAMS = 16_448_060


def _jax_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}


def _stub_plan(monkeypatch, discolib, cfg):
    nb = len(discolib.morlet_basis_spec(cfg.filter_ell_max,
                                        cfg.filter_m_max))
    monkeypatch.setattr(discolib, "make_disco_plan",
                        lambda *a, **k: types.SimpleNamespace(
                            n_basis=nb, stride=2))


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("config", ["smoke", "full"])
def test_channel_specs_match_jax(monkeypatch, config, mesh):
    jcfg = getattr(jcfgs, f"fcn3_{config}")()
    tcfg = getattr(tcfgs, f"fcn3_{config}")()
    if config == "full":
        # the parameters' shapes need the modules, not the plans
        _stub_plan(monkeypatch, jfcn3.discolib, jcfg)
        _stub_plan(monkeypatch, tfcn3.discolib, tcfg)
    jparams = jax.eval_shape(jfcn3.FCN3(jcfg).init, jax.random.PRNGKey(0))
    jmesh = types.SimpleNamespace(axis_names=("data", "model"),
                                  devices=np.empty(mesh))
    want = _jax_specs(jsharding.sanitize_specs(
        jmesh, jsharding.fcn3_param_specs(jparams, mode="channel"),
        jparams))
    with counting.DryRun("cpu"):
        model = tfcn3.FCN3(tcfg, device="cpu")
        got = channel.channel_specs(model, {"data": mesh[0],
                                            "model": mesh[1]})
        shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert {k.replace(".", "/"): v for k, v in got.items()} == want
    split = [k for k, s in got.items() if sharding.is_split(s)]
    n = sum(int(np.prod(shapes[k])) for k in split)
    if config == "full":
        assert (len(split), n) == (FULL_SPLIT_LEAVES, FULL_SPLIT_PARAMS)
        assert {k.rsplit(".", 1)[1] for k in split} == {"w1", "b1", "w2"}
    else:
        assert len(split) == 9
        assert {k.rsplit(".", 1)[1] for k in split} == {
            "w_re", "w_im", "weight", "w1", "b1", "w2"}


def test_local_blocks_take_this_ranks_block_of_a_numpy_state():
    # a state dict from arrays.npz onto rank (data 1, model 1) of 2 x 2
    class Mesh:
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return 2

        def get_local_rank(self, axis):
            return {"data": 1, "model": 1}[axis]

    a = np.arange(4 * 6, dtype=np.float32).reshape(4, 6)
    b = np.arange(5, dtype=np.float32)
    specs = {"a": ("model", "data"), "b": (None,)}
    got = sharding.local_blocks({"a": a, "b": b}, specs, Mesh())
    np.testing.assert_array_equal(got["a"], a[2:4, 3:6])
    assert got["b"] is b
    with pytest.raises(ValueError, match="does not split"):
        sharding.local_blocks({"b": b}, {"b": ("model",)}, Mesh())


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    cfg = jcfgs.fcn3_smoke()
    model = jfcn3.FCN3(cfg)
    params = model.init(jax.random.PRNGKey(0))
    cw = jcfgs.channel_weights(cfg.n_levels)
    bufs = dict(model.make_buffers(),
                **jtr.EnsembleTrainer(model, jtr.TrainConfig(),
                                      cw).make_loss_buffers())
    flat = {k: np.asarray(v)
            for k, v in jckpt._flatten_with_paths(params).items()}
    return {"model": model, "ds": jdata.SyntheticERA5(cfg),
            "params": params, "flat": flat, "cw": cw, "bufs": bufs}


def _world(ref, tcfg, mesh, placement, batch, tmp=None):
    """The world of ``mesh``, JAX's loss and gradients and one process's
    on the same global batch and draws."""
    e, steps = tcfg["ensemble_size"], tcfg["rollout_steps"]
    jb = next(iter(jdata.Loader(ref["ds"], global_batch=batch,
                                rollout=steps)))
    jb = {k: np.array(v) for k, v in jb.items()}
    key = jax.random.PRNGKey(7)
    noise = ref["model"].noise
    nb = ref["bufs"]["noise"]
    z0 = np.array(noise.init_state(key, (e, batch), nb))
    etas = [np.array(noise._sample_coeffs(jax.random.fold_in(key, n),
                                          (e, batch), nb["sigma_l"]))
            for n in range(steps - 1)]
    jtrainer = jtr.EnsembleTrainer(ref["model"], jtr.TrainConfig(**tcfg),
                                   ref["cw"])
    (jl, _), jg = jax.jit(jax.value_and_grad(
        jtrainer.rollout_loss, has_aux=True))(
        ref["params"], ref["bufs"], {k: jnp.asarray(v) for k, v in
                                     jb.items()}, key)
    jg = {k.replace("/", "."): np.asarray(v)
          for k, v in jckpt._flatten_with_paths(jg).items()}
    member_axes = ("model", "data") if placement == "domain" else None
    setup = {"params": ref["flat"], "cw": ref["cw"], "batch": jb,
             "z_hat0": z0, "etas": etas, "mesh": mesh,
             "placement": placement, "ckpt": tmp,
             "tcfg": dict(tcfg, member_axes=member_axes)}
    res = run_world(workers.channel_rank, mesh[0] * mesh[1], (setup,),
                    timeout=TIMEOUT, threads=1)
    model = tfcn3.FCN3(tcfgs.fcn3_smoke(), device="cpu")
    tparams.load_into(model, ref["flat"])
    single = ttr.EnsembleTrainer(model, ttr.TrainConfig(**tcfg), ref["cw"])
    sl, _, sg = single.loss_and_grads(
        dict(model.make_buffers(), **single.make_loss_buffers()),
        {k: torch.from_numpy(v) for k, v in jb.items()},
        InjectedNoise(z0, etas))
    return {"jax": (float(jl), jg), "ranks": res,
            "single": (float(sl), {k: v.numpy() for k, v in sg.items()})}


@pytest.fixture(scope="module", params=MESHES, ids=["1x2", "2x2"])
def channel_step(ref, request, tmp_path_factory):
    mesh = request.param
    tmp = str(tmp_path_factory.mktemp("channel_ckpt"))
    out = _world(ref, dict(ensemble_size=2, rollout_steps=1,
                           fair_crps=True), mesh, "channel", mesh[0], tmp)
    out["mesh"] = mesh
    return out


def test_channel_ranks_import_no_jax_and_split_nine_leaves(channel_step):
    for r in channel_step["ranks"]:
        assert not r["jax_loaded"] and r["whole_members"]
        assert len(r["split"]) == 9
        # the block's collectives: the MLPs' and the split convs' sums
        # and the convs' gathers
        assert r["kinds"]["all_gather"] > 0 and r["kinds"]["all_reduce"] > 0


def test_channel_loss_matches_jax_and_one_process(channel_step):
    jl, _ = channel_step["jax"]
    sl, _ = channel_step["single"]
    for r in channel_step["ranks"]:
        np.testing.assert_allclose(r["loss"], sl, rtol=1e-5)
        np.testing.assert_allclose(r["loss"], jl, rtol=1e-4)


def test_channel_gradients_match_jax_and_one_process(channel_step):
    _, jg = channel_step["jax"]
    _, sg = channel_step["single"]
    want_norm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                                  for g in sg.values())))
    for r in channel_step["ranks"]:
        assert set(r["grads"]) == set(sg)
        for k, want in sg.items():
            np.testing.assert_allclose(r["grads"][k], want, rtol=2e-3,
                                       atol=2e-4, err_msg=k)
            np.testing.assert_allclose(r["grads"][k], jg[k], rtol=2e-3,
                                       atol=2e-4, err_msg=k)
        # the clipping's norm: the split leaves' squares summed over ranks
        np.testing.assert_allclose(r["norm"], want_norm, rtol=1e-5)
        assert r["step_norm"] == r["norm"]


def test_each_rank_holds_its_blocks_of_the_gathered_leaves(channel_step):
    nd, nm = channel_step["mesh"]
    for rank, r in enumerate(channel_step["ranks"]):
        m = rank % nm
        for k, block in r["blocks"].items():
            whole = r["grads"][k]
            dim = 1 if k.endswith("w2") else 0
            size = whole.shape[dim] // nm
            np.testing.assert_array_equal(
                block, np.take(whole, range(m * size, (m + 1) * size),
                               axis=dim))
            np.testing.assert_array_equal(
                r["local_params"][k],
                np.take(r["params"][k], range(m * size, (m + 1) * size),
                        axis=dim))
    r0, *rest = channel_step["ranks"]
    for r in rest:
        for k in r0["params"]:
            np.testing.assert_array_equal(r["params"][k], r0["params"][k])


def test_channel_checkpoint_reloads_in_one_process_bit_for_bit(
        channel_step, ref):
    r0 = channel_step["ranks"][0]
    params, opt_state, manifest = tckpt.restore_checkpoint(r0["ckpt"])
    model = tfcn3.FCN3(tcfgs.fcn3_smoke(), device="cpu")
    model.load_state_dict(params, strict=True)
    for k, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), r0["params"][k])
    # the moments are whole leaves, in the reference's format
    assert {k: tuple(v.shape) for k, v in opt_state["mu"].items()} == {
        k: v.shape for k, v in r0["params"].items()}
    # and the JAX package's restore reads it
    restored, _ = jckpt.restore_checkpoint(r0["ckpt"],
                                           {"params": ref["params"]})
    flat = jckpt._flatten_with_paths(restored["params"])
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(v),
                                      r0["params"][k.replace("/", ".")])
    assert manifest["step"] == 1


def test_an_ensemble_the_model_axis_does_not_divide_runs_whole(ref):
    out = _world(ref, dict(ensemble_size=3, rollout_steps=1,
                           fair_crps=True), (1, 2), "domain", 1)
    sl, sg = out["single"]
    jl, jg = out["jax"]
    for r in out["ranks"]:
        assert r["whole_members"] and not r["split"]
        np.testing.assert_allclose(r["loss"], sl, rtol=1e-5)
        np.testing.assert_allclose(r["loss"], jl, rtol=1e-4)
        for k, want in sg.items():
            np.testing.assert_allclose(r["grads"][k], want, rtol=2e-3,
                                       atol=2e-4, err_msg=k)
            np.testing.assert_allclose(r["grads"][k], jg[k], rtol=2e-3,
                                       atol=2e-4, err_msg=k)


def test_channel_placement_needs_a_mesh_and_whole_members():
    model = tfcn3.FCN3(tcfgs.fcn3_smoke(), device="cpu")
    with pytest.raises(ValueError, match="channel placement"):
        ttr.EnsembleTrainer(model, ttr.TrainConfig(), jcfgs.channel_weights(2),
                            placement="channel")
