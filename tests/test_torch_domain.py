"""The port's domain-decomposed FCN3 training step
(``repro_torch.distributed.domain``, the trainer with a mesh and no
``member_axes``, ``launch/train.py --fcn3-sharding domain``) against numpy
emulations and the JAX package's single-device step.

Worlds run in spawned processes over gloo (``distributed.world.
run_world``); the rank bodies live in the JAX-free ``_torch_dist_workers``
and every rank checks that it imported no JAX.  At ``fcn3_smoke`` the
latitude splits raggedly: 33 IO rows over 2 ranks are 16 / 17, over 4
ranks 8 / 8 / 8 / 9 (the JAX loader's ``(h * i) // n``).

* the rank-local geometry in numpy: ``row_block`` is the loader's split,
  ``halo_rows`` the rows the live taps read (the wrap rows' too, from up
  to two ranks away), ``local_band_rows`` contracts the gathered rows to
  the whole contraction's rows;
* ``all_to_all_v`` and ``halo_exchange`` with their gradients against a
  numpy emulation, in a world of 3;
* on 2 and 4 ranks, from the JAX package's parameters: the gathered
  forward against ``FCN3.apply`` (rtol 1e-4, atol 1e-5), the loss and its
  terms against the JAX ``rollout_loss`` with the reference's draws
  (rtol 1e-5), the gradients (rtol 2e-3, atol 2e-4), the parameters
  bitwise equal on every rank after an Adam step, and the eval step
  against the JAX ``make_eval_step`` (rtol 1e-4, the bar of
  ``tests/test_torch_train.py``), also on a 2 x 2 data x model mesh;
* the launcher's ``--fcn3-sharding domain`` on 2 ranks, and ``channel``
  (once refused) on 2 ranks, its checkpoint written whole.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import few_torch_threads  # noqa: F401

import _torch_dist_workers as workers
from repro.configs import fcn3 as jcfgs
from repro.core.fcn3 import FCN3 as JFCN3
from repro.data import era5_synthetic as jdata
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtr
from repro_torch.configs import fcn3 as tcfgs
from repro_torch.core.fcn3 import FCN3 as TFCN3
from repro_torch.data import era5_synthetic as tdata
from repro_torch.distributed import domain
from repro_torch.distributed.compat import row_block
from repro_torch.distributed.world import run_world
from repro_torch.kernels import dispatch
from repro_torch.train import checkpoint as tckpt

TIMEOUT = 120.0
EVAL_MEMBERS = 3
TCFG = dict(ensemble_size=2, rollout_steps=2, fair_crps=True,
            noise_centering=True)


def _rng(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def smoke():
    return TFCN3(tcfgs.fcn3_smoke(), device="cpu")


# ---------------------------------------------------------------------------
# rank-local geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h", [33, 181, 721])
def test_row_block_is_the_loaders_split(h):
    for n in (1, 2, 3, 4):
        blocks = [row_block(h, i, n) for i in range(n)]
        assert blocks == [((h * i) // n, (h * (i + 1)) // n)
                          for i in range(n)]
        assert blocks[0][0] == 0 and blocks[-1][1] == h
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    assert [row_block(721, i, 2) for i in range(2)] == [(0, 360), (360, 721)]


def test_port_loader_keeps_the_row_block():
    ds = tdata.SyntheticERA5(tcfgs.fcn3_smoke(), device="cpu")
    whole = next(iter(tdata.Loader(ds, global_batch=1)))
    for i in range(4):
        lo, hi = row_block(33, i, 4)
        got = next(iter(tdata.Loader(ds, global_batch=1, lat_shard=(i, 4))))
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(),
                                          whole[k][..., lo:hi, :].numpy())
            # a copy of the rows, not a view that keeps the whole field
            assert v.untyped_storage().nbytes() == v.numel() * v.element_size()


@pytest.mark.parametrize("mode", ["full", "depthwise"])
def test_spectral_filter_on_a_block_of_degrees(mode):
    """``apply_weights`` with a map to a block of degrees (what the domain
    step's global blocks pass) is the whole product's block, in each of
    the filter's modes."""
    from repro_torch.core.sphere.spectral_conv import SpectralFilter
    filt = SpectralFilter(3, 3, 7, mode=mode)
    filt.reset(torch.Generator().manual_seed(0))
    if mode == "depthwise":
        with torch.no_grad():
            filt.w.copy_(torch.from_numpy(_rng(1, (3, 7))))
    c = torch.complex(torch.from_numpy(_rng(2, (2, 3, 7, 5))),
                      torch.from_numpy(_rng(3, (2, 3, 7, 5))))
    whole = filt.apply_weights(c)
    for lo, hi in ((0, 4), (4, 7)):
        got = filt.apply_weights(c[..., lo:hi, :],
                                 lambda w, lo=lo, hi=hi: w[..., lo:hi])
        torch.testing.assert_close(got, whole[..., lo:hi, :], rtol=1e-6,
                                   atol=1e-6)


def _plans(model):
    return {"enc": (model.enc_plan, 16), "latent": (model.latent_plan, 16),
            "dec": (model.dec_plan, 33)}


@pytest.mark.parametrize("name", ["enc", "latent", "dec"])
def test_halo_rows_are_the_rows_the_live_taps_read(smoke, name):
    plan, h_out = _plans(smoke)[name]
    band, wrap_rows, psi_wrap = plan.banded_split()
    for n in (2, 4):
        for i in range(n):
            lo, hi = row_block(h_out, i, n)
            want = set()
            for h in range(lo, hi):
                for s in range(plan.lat_idx.shape[1]):
                    live = band[:, h, s].any()
                    if h in wrap_rows:
                        w = int(np.flatnonzero(wrap_rows == h)[0])
                        live |= psi_wrap[:, w, s].any()
                    if live:
                        want.add(int(plan.lat_idx[h, s]))
            got = domain.halo_rows(plan, lo, hi)
            assert list(got) == sorted(want)
    # the wrap rows are the near-pole rows, and their taps are read
    assert set(wrap_rows) & set(range(*row_block(h_out, 0, 2)))


def test_a_block_is_read_from_two_ranks_away(smoke):
    plan = smoke.latent_plan
    n = 8                       # blocks of 2 latent rows
    blocks = [row_block(16, i, n) for i in range(n)]
    need = [domain.halo_rows(plan, *b) for b in blocks]
    owners = {q for q, (lo, hi) in enumerate(blocks)
              for r in need[3] if lo <= r < hi}
    assert {1, 5} <= owners      # two ranks either side
    halo = domain.Halo.of(need, blocks, 1)
    assert halo.send_sizes[3] > 0 and halo.send_sizes[1] == 0
    assert sum(halo.recv_sizes) + len(halo.own) == len(need[1])


@pytest.mark.parametrize("name", ["enc", "latent", "dec"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_local_band_rows_contract_the_whole_contractions_rows(smoke, name,
                                                             n):
    plan, h_out = _plans(smoke)[name]
    x = torch.from_numpy(_rng(n, (3, plan.grid_in.nlat, plan.grid_in.nlon)))
    whole = dispatch.disco_conv_banded_buffers(x, plan.banded_buffers(),
                                               plan.stride)
    taps = 0
    for i in range(n):
        lo, hi = row_block(h_out, i, n)
        need = domain.halo_rows(plan, lo, hi)
        loc = domain.local_band_rows(plan, (lo, hi), need)
        assert loc["lat_idx"].max() < len(need)
        np.testing.assert_array_equal(loc["psi_band"],
                                      plan.banded_split()[0][:, lo:hi])
        assert all(0 <= r < hi - lo for r in loc["wrap_rows"])
        got = dispatch.disco_conv_banded_buffers(
            x[:, need], {k: torch.from_numpy(v) for k, v in loc.items()},
            plan.stride)
        np.testing.assert_allclose(got.numpy(), whole[:, :, lo:hi].numpy(),
                                   rtol=1e-6, atol=1e-7)
        taps += loc["tap_ent"].shape[0]
    # every live tap of the band lands on exactly one rank
    assert taps == plan.live_taps()["tap_ent"].shape[0]


def test_local_band_rows_refuse_rows_that_miss_a_tap(smoke):
    plan = smoke.latent_plan
    need = domain.halo_rows(plan, 0, 8)
    with pytest.raises(ValueError, match="need misses"):
        domain.local_band_rows(plan, (0, 8), need[:-1])


# ---------------------------------------------------------------------------
# the ragged all-to-all and the halo exchange
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ragged():
    n = 3
    sizes = np.array([[0, 2, 1], [3, 0, 0], [1, 4, 0]])
    blocks = [row_block(10, i, n) for i in range(n)]
    need = [np.array([0, 1, 2, 3, 5]), np.array([2, 3, 4, 5, 6, 9]),
            np.array([0, 5, 6, 7, 8, 9])]
    ins = {"x": _rng(20, (n, 2, 6, 5)), "sizes": sizes,
           "ct_a2av": _rng(21, (n, 2, 6, 5)), "blocks": blocks,
           "need": need, "field": _rng(22, (2, 10, 5)),
           "ct_halo": [_rng(23 + i, (2, len(need[i]), 5))
                       for i in range(n)]}
    return ins, run_world(workers.ragged_rank, n, (ins,), timeout=TIMEOUT,
                          threads=1)


def test_all_to_all_v_and_its_gradient(ragged):
    ins, res = ragged
    x, sizes, ct = ins["x"], ins["sizes"], ins["ct_a2av"]
    n = len(res)
    off = np.concatenate([np.zeros((n, 1), int), np.cumsum(sizes, 1)], 1)
    for r in range(n):
        want = np.concatenate([x[q][:, off[q, r]:off[q, r + 1]]
                               for q in range(n)], axis=1)
        got, grad = res[r]["a2av"]
        np.testing.assert_array_equal(got, want)
        assert res[r]["received"] == want.size * 4
        # the gradient is the reverse exchange: rows sent to q get back
        # q's cotangent of them; rows not sent get none
        recv_off = np.concatenate([[0], np.cumsum(sizes[:, r])])
        want_g = np.zeros_like(x[r])
        for q in range(n):
            qoff = np.concatenate([[0], np.cumsum(sizes[:, q])])
            want_g[:, off[r, q]:off[r, q + 1]] = ct[q][:, qoff[r]:qoff[r + 1]]
        np.testing.assert_array_equal(grad, want_g)
        assert recv_off[-1] == got.shape[1]


def test_halo_exchange_and_its_gradient(ragged):
    ins, res = ragged
    field, need, blocks = ins["field"], ins["need"], ins["blocks"]
    full_g = np.zeros_like(field)
    for q, ct in enumerate(ins["ct_halo"]):
        np.add.at(full_g, (slice(None), need[q]), ct)
    for r, (lo, hi) in enumerate(blocks):
        got, grad = res[r]["halo"]
        np.testing.assert_array_equal(got, field[:, need[r]])
        # each gathered row's gradient went back to its owner
        np.testing.assert_allclose(grad, full_g[:, lo:hi], rtol=1e-6)


# ---------------------------------------------------------------------------
# the domain-decomposed step against the JAX single-device step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    """The JAX model's init, its forward of random inputs, and its
    rollout loss, terms and gradients on one batch with fixed draws."""
    cfg = jcfgs.fcn3_smoke()
    model = JFCN3(cfg)
    params = model.init(jax.random.PRNGKey(0))
    cw = jcfgs.channel_weights(cfg.n_levels)
    jtrainer = jtr.EnsembleTrainer(model, jtr.TrainConfig(**TCFG), cw)
    bufs = dict(model.make_buffers(), **jtrainer.make_loss_buffers())
    state = _rng(30, (2, cfg.n_state, cfg.nlat, cfg.nlon))
    cond = _rng(31, (2, cfg.n_cond_in, cfg.nlat, cfg.nlon))
    fwd = np.asarray(model.apply(params, bufs, jnp.asarray(state),
                                 jnp.asarray(cond)))
    steps, e = TCFG["rollout_steps"], TCFG["ensemble_size"]
    jb = next(iter(jdata.Loader(jdata.SyntheticERA5(cfg), global_batch=1,
                                rollout=steps)))
    jb = {k: np.array(v) for k, v in jb.items()}
    key = jax.random.PRNGKey(7)
    nb = bufs["noise"]
    z0 = np.array(model.noise.init_state(key, (e, 1), nb))
    etas = [np.array(model.noise._sample_coeffs(jax.random.fold_in(key, n),
                                                (e, 1), nb["sigma_l"]))
            for n in range(steps - 1)]
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        jtrainer.rollout_loss, has_aux=True))(
        params, bufs, {k: jnp.asarray(v) for k, v in jb.items()}, key)
    flat = {k: np.asarray(v)
            for k, v in jckpt._flatten_with_paths(params).items()}
    # the eval step, on the same batch from draws of its own
    ekey = jax.random.PRNGKey(4)
    ez0 = np.array(model.noise.init_state(ekey, (EVAL_MEMBERS, 1), nb))
    ev = jax.jit(jtrainer.make_eval_step(bufs, n_members=EVAL_MEMBERS))(
        params, {k: jnp.asarray(v) for k, v in jb.items()}, ekey)
    setup = {"params": flat, "cw": cw, "batch": jb, "z_hat0": z0,
             "etas": etas, "tcfg": TCFG, "state": state, "cond": cond,
             "eval_z_hat0": ez0, "eval_members": EVAL_MEMBERS}
    return {"setup": setup, "forward": fwd, "loss": float(jl),
            "eval": {k: float(v) for k, v in ev.items()},
            "jtrainer": jtrainer, "bufs": bufs, "params": params,
            "aux": {k: float(v) for k, v in jaux.items()},
            "grads": {k.replace("/", "."): np.asarray(v)
                      for k, v in jckpt._flatten_with_paths(jg).items()}}


@pytest.fixture(scope="module", params=[2, 4], ids=["R2", "R4"])
def world(ref, request):
    return request.param, run_world(workers.domain_rank, request.param,
                                    (ref["setup"],), timeout=TIMEOUT,
                                    threads=1)


def test_ranks_hold_the_loaders_row_blocks(world):
    n, res = world
    for i, r in enumerate(res):
        assert r["rows"] == row_block(33, i, n)
        assert tuple(r["latent_rows"]) == row_block(16, i, n)
        assert not r["jax_loaded"]
        assert r["halo_bytes"] > 0


def test_gathered_forward_matches_jax(ref, world):
    _, res = world
    got = np.concatenate([r["forward"] for r in res], axis=-2)
    np.testing.assert_allclose(got, ref["forward"], rtol=1e-4, atol=1e-5)


def test_loss_and_terms_match_jax(ref, world):
    _, res = world
    for r in res:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-5)
        assert set(r["aux"]) == set(ref["aux"])
        for k, want in ref["aux"].items():
            np.testing.assert_allclose(r["aux"][k], want, rtol=1e-5,
                                       err_msg=k)


def test_gradients_match_jax(ref, world):
    _, res = world
    for r in res:
        assert set(r["grads"]) == set(ref["grads"])
        for k, want in ref["grads"].items():
            np.testing.assert_allclose(r["grads"][k], want, rtol=2e-3,
                                       atol=2e-4, err_msg=k)


def test_eval_step_matches_jax(ref, world):
    _, res = world
    for r in res:
        for k, want in ref["eval"].items():
            np.testing.assert_allclose(r["eval"][k], want, rtol=1e-4,
                                       err_msg=k)


def test_eval_step_on_a_data_by_model_mesh_matches_jax(ref):
    # two samples over the data axis, latitude over the model axis
    cfg = jcfgs.fcn3_smoke()
    jb = next(iter(jdata.Loader(jdata.SyntheticERA5(cfg), global_batch=2,
                                rollout=1)))
    jb = {k: np.array(v) for k, v in jb.items()}
    key = jax.random.PRNGKey(5)
    nb = ref["bufs"]["noise"]
    model = ref["jtrainer"].model
    z0 = np.array(model.noise.init_state(key, (EVAL_MEMBERS, 2), nb))
    want = jax.jit(ref["jtrainer"].make_eval_step(
        ref["bufs"], n_members=EVAL_MEMBERS))(
        ref["params"], {k: jnp.asarray(v) for k, v in jb.items()}, key)
    setup = dict(ref["setup"], batch=jb, eval_z_hat0=z0, mesh=(2, 2))
    res = run_world(workers.domain_eval_rank, 4, (setup,), timeout=TIMEOUT,
                    threads=1)
    assert [r["rows"] for r in res] == [row_block(33, i % 2, 2)
                                        for i in range(4)]
    for r in res:
        assert not r["jax_loaded"]
        for k in ("crps", "rmse_ens_mean"):
            np.testing.assert_allclose(r["eval"][k], float(want[k]),
                                       rtol=1e-4, err_msg=k)


def test_every_rank_holds_the_same_parameters_after_a_step(ref, world):
    _, (r0, *rest) = world
    for r in rest:
        for k in r0["params"]:
            np.testing.assert_array_equal(r["params"][k], r0["params"][k])
    init = ref["setup"]["params"]
    assert not [k for k, v in r0["params"].items()
                if np.array_equal(v, init[k.replace(".", "/")])]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_on_latitude_blocks_in_a_world_of_two():
    argv = ["--config", "smoke", "--device", "cpu", "--steps", "2",
            "--fcn3-sharding", "domain", "--mesh-model", "2",
            "--dist-backend", "gloo"]
    hist = run_world(workers.launcher_rank, 2, (argv,), timeout=TIMEOUT,
                     threads=1)
    assert [len(h) for h in hist] == [2, 2]
    for a, b in zip(*hist):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
        assert np.isfinite(a["loss"]) and a["grad_norm"] > 0
        assert 0 < a["collective_s"] < a["seconds"]
        assert a["halo_bytes"] > 0 and b["halo_bytes"] > 0


def test_launcher_refuses_the_channel_sharding(tmp_path):
    # refused until the channel placement ran: now both ranks take the
    # same steps and rank 0 writes the split leaves whole
    argv = ["--config", "smoke", "--device", "cpu", "--steps", "2",
            "--fcn3-sharding", "channel", "--mesh-model", "2",
            "--dist-backend", "gloo", "--ckpt-dir", str(tmp_path)]
    hist = run_world(workers.launcher_rank, 2, (argv,), timeout=TIMEOUT,
                     threads=1)
    for a, b in zip(*hist):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
        assert np.isfinite(a["loss"]) and a["grad_norm"] > 0
        assert a["kind_bytes"]["all_gather"] > 0
    params, opt, _ = tckpt.restore_checkpoint(str(tmp_path / "ckpt_00000002"))
    model = TFCN3(tcfgs.fcn3_smoke(), device="cpu")
    model.load_state_dict(params, strict=True)
    assert opt["mu"]["blocks.0.mlp.w1"].shape == model.blocks[0].mlp.w1.shape
