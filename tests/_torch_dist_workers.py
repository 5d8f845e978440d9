"""Rank bodies for ``tests/test_torch_distributed.py``.

They run in processes spawned by ``repro_torch.distributed.world``, so
this module imports no JAX (each rank checks that ``jax`` is not in
``sys.modules``): the test computes the JAX references in its own
process and hands the ranks numpy inputs.
"""

import sys

import numpy as np
import torch

MESH, AXES = (2, 2, 2), ("ens", "lat", "lon")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def collectives(groups, coord, inputs) -> dict:
    """compat's collectives on this rank's slab of each input, with the
    gradient of a fixed cotangent through each."""
    from repro_torch.distributed import compat
    out = {"size": {a: compat.axis_size(g) for a, g in groups.items()},
           "index": {a: compat.axis_index(g) for a, g in groups.items()}}
    g = groups["lon"]
    r = compat.axis_index(g)
    for name, (split, concat) in (("a2a_0_2", (0, 2)), ("a2a_2_0", (2, 0)),
                                  ("a2a_1_1", (1, 1))):
        x = torch.from_numpy(inputs["x"][r]).requires_grad_(True)
        y = compat.all_to_all(x, g, split, concat)
        ct = torch.from_numpy(inputs[f"ct_{name}"][r])
        (gx,) = torch.autograd.grad(y, x, ct)
        out[name] = (_np(y), _np(gx))
    z = torch.from_numpy(inputs["z"][r])
    out["a2a_complex"] = _np(compat.all_to_all(z, g, 1, 0))
    x = torch.from_numpy(inputs["x"][r]).requires_grad_(True)
    y = compat.psum_scatter(x, g, 1)
    (gx,) = torch.autograd.grad(y, x, torch.from_numpy(inputs["ct_rs"][r]))
    out["psum_scatter"] = (_np(y), _np(gx))
    # a replicated scalar: every rank backpropagates the same loss
    x = torch.from_numpy(inputs["x"][r]).requires_grad_(True)
    loss = compat.psum((x * x).sum(), g)
    (gx,) = torch.autograd.grad(loss, x)
    out["psum"] = (float(loss), _np(gx))
    out["psum_complex"] = _np(compat.psum(z, g))
    return out


def algorithms(groups, coord, inputs) -> dict:
    """Algorithms 1-3 on this rank's blocks of the selftest inputs."""
    from repro_torch.core.sphere import disco, grids, sht
    from repro_torch.distributed import dist_crps, dist_disco, dist_sht
    e, la, lo = coord
    rows, cols = slice(la * 16, (la + 1) * 16), slice(lo * 32, (lo + 1) * 32)
    t = sht.SHT.create(grids.make_grid(32, 64, "gauss"), lmax=32, mmax=32)
    m0, m1 = dist_sht.order_block(t.mmax, MESH[2], lo)
    local = dist_sht.local_sht_buffers(t, m0, m1)
    x = torch.from_numpy(inputs["sht_x"])
    c = dist_sht.dist_sht_forward(x[:, :, rows, cols].contiguous(), local,
                                  t.mmax, groups["lat"], groups["lon"])
    cin = torch.from_numpy(inputs["sht_c"])[:, :, rows, m0:m1].contiguous()
    u = dist_sht.dist_sht_inverse(cin, local, 64, groups["lat"],
                                  groups["lon"])
    out = {"sht_forward": _np(c), "sht_inverse": _np(u), "orders": (m0, m1)}
    g = grids.make_grid(32, 64, "equiangular")
    plan = disco.make_disco_plan(g, g, cutoff_factor=3.0)
    xd = torch.from_numpy(inputs["disco_x"])[:, :, rows, cols].contiguous()
    blocks, _ = dist_disco.local_psi_blocks(plan, MESH[1])
    for name, loc in (("band", dist_disco.local_band_buffers(plan, la,
                                                             MESH[1])),
                      ("dense", torch.from_numpy(blocks[la]))):
        out[f"disco_{name}"] = _np(dist_disco.dist_disco_conv(
            xd, loc, plan.stride, groups["lat"], groups["lon"]))
    ens = torch.from_numpy(inputs["crps_ens"][2 * e:2 * e + 2])
    for fair in (False, True):
        out[f"crps_{fair}"] = float(dist_crps.dist_crps(
            ens, torch.from_numpy(inputs["crps_obs"]),
            torch.from_numpy(inputs["crps_w"]), groups["ens"], fair))
    return out


def selftest_rank(rank: int, world_size: int, inputs: dict) -> dict:
    """The collectives and Algorithms 1-3 on the (ens, lat, lon) mesh."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(MESH, AXES, "cpu")
    groups = {a: mesh.get_group(a) for a in AXES}
    coord = tuple(mesh.get_coordinate())
    return {"coord": coord, "jax_loaded": "jax" in sys.modules,
            "collectives": collectives(groups, coord, inputs),
            "algorithms": algorithms(groups, coord, inputs)}


def train_rank(rank: int, world_size: int, setup: dict) -> dict:
    """One ensemble-parallel loss, gradient and Adam step of the
    ``fcn3_smoke`` trainer on a (data 2, model 2) mesh, from the given
    parameters, global batch and noise draws."""
    from repro_torch.configs import fcn3 as tcfgs
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.inference import params as tparams
    from repro_torch.inference.engine import InjectedNoise
    from repro_torch.launch.mesh import make_toy_mesh
    from repro_torch.train import trainer as ttr
    mesh = make_toy_mesh(2, 2)
    model = FCN3(tcfgs.fcn3_smoke(), device="cpu")
    tparams.load_into(model, setup["params"])
    if rank:   # the trainer broadcasts rank 0's parameters
        for p in model.parameters():
            p.detach().mul_(0.5)
    tr = ttr.EnsembleTrainer(model, ttr.TrainConfig(**setup["tcfg"]),
                             setup["cw"], mesh=mesh)
    bufs = dict(model.make_buffers(), **tr.make_loss_buffers())
    d = mesh.get_local_rank("data")
    batch = {k: torch.from_numpy(v[d:d + 1]) for k, v in
             setup["batch"].items()}

    def noise():
        return InjectedNoise(setup["z_hat0"], setup["etas"])

    loss, aux, grads = tr.loss_and_grads(bufs, batch, noise())
    state = tr.optimizer.init(dict(model.named_parameters()))
    tr.train_step(bufs, state, batch, noise())
    return {"loss": float(loss), "aux": {k: float(v) for k, v in aux.items()},
            "grads": {k: _np(v) for k, v in grads.items()},
            "params": {k: _np(p) for k, p in model.named_parameters()},
            "jax_loaded": "jax" in sys.modules}


def launcher_rank(rank: int, world_size: int, argv: list) -> list:
    """``launch/train.py``'s CLI in a world its caller set up."""
    from repro_torch.launch import train
    return train.main(argv)


def ragged_rank(rank: int, world_size: int, inputs: dict) -> dict:
    """``all_to_all_v`` and ``halo_exchange`` on this rank's rows, with
    the gradient of a fixed cotangent through each."""
    from repro_torch.distributed import compat, domain
    x = torch.from_numpy(inputs["x"][rank]).requires_grad_(True)
    sizes = inputs["sizes"]
    send = [int(sizes[rank, q]) for q in range(world_size)]
    recv = [int(sizes[q, rank]) for q in range(world_size)]
    rows = x[..., :sum(send), :]
    compat.start_timing()
    y = compat.all_to_all_v(rows, None, -2, send, recv)
    received = compat.timed_bytes()
    (gx,) = torch.autograd.grad(y, x, torch.from_numpy(
        inputs["ct_a2av"][rank][..., :sum(recv), :]))
    out = {"a2av": (_np(y), _np(gx)), "received": received}
    halo = domain.Halo.of(inputs["need"], inputs["blocks"], rank)
    lo, hi = inputs["blocks"][rank]
    f = torch.from_numpy(inputs["field"][..., lo:hi, :]).requires_grad_(True)
    h = domain.halo_exchange(f, halo, None)
    (gf,) = torch.autograd.grad(h, f, torch.from_numpy(
        inputs["ct_halo"][rank]))
    out["halo"] = (_np(h), _np(gf))
    return out


def domain_rank(rank: int, world_size: int, setup: dict) -> dict:
    """The domain-decomposed ``fcn3_smoke`` step on a (data 1, model R)
    mesh, from the given parameters: one forward of the given inputs on
    this rank's rows; then, from the given batch and noise draws, the
    loss, its terms and the reduced gradients, and the parameters after
    one Adam step."""
    from repro_torch.configs import fcn3 as tcfgs
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.distributed import compat
    from repro_torch.inference import params as tparams
    from repro_torch.inference.engine import InjectedNoise
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import trainer as ttr
    mesh = make_mesh((1, world_size), ("data", "model"), "cpu")
    model = FCN3(tcfgs.fcn3_smoke(), device="cpu")
    tparams.load_into(model, setup["params"])
    if rank:   # the trainer broadcasts rank 0's parameters
        for p in model.parameters():
            p.detach().mul_(0.5)
    tr = ttr.EnsembleTrainer(model, ttr.TrainConfig(**setup["tcfg"]),
                             setup["cw"], mesh=mesh)
    d = tr.domain
    lo, hi = d.io_block
    bufs = dict(d.make_buffers(), **tr.make_loss_buffers())
    with torch.no_grad():
        fwd = d(bufs, torch.from_numpy(setup["state"][..., lo:hi, :]),
                torch.from_numpy(setup["cond"][..., lo:hi, :]))
    batch = {k: torch.from_numpy(v[..., lo:hi, :])
             for k, v in setup["batch"].items()}
    # the eval step on the initial parameters, from its own draws
    ev = tr.eval_step(bufs, batch, InjectedNoise(setup["eval_z_hat0"], []),
                      n_members=setup["eval_members"])

    def noise():
        return InjectedNoise(setup["z_hat0"], setup["etas"])

    compat.start_timing()
    loss, aux, grads = tr.loss_and_grads(bufs, batch, noise())
    halo_bytes = compat.timed_bytes()
    state = tr.optimizer.init(dict(model.named_parameters()))
    tr.train_step(bufs, state, batch, noise())
    return {"rows": (lo, hi), "latent_rows": d.lat_block,
            "forward": _np(fwd), "loss": float(loss),
            "aux": {k: float(v) for k, v in aux.items()},
            "grads": {k: _np(v) for k, v in grads.items()},
            "params": {k: _np(p) for k, p in model.named_parameters()},
            "halo_bytes": halo_bytes, "jax_loaded": "jax" in sys.modules,
            "eval": {k: float(v) for k, v in ev.items()}}


def domain_eval_rank(rank: int, world_size: int, setup: dict) -> dict:
    """The domain-decomposed ``fcn3_smoke`` eval step on a (data, model)
    mesh of ``setup["mesh"]``: this rank's slice of the global batch on
    its latitude rows, from the given parameters and noise draws."""
    from repro_torch.configs import fcn3 as tcfgs
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.inference import params as tparams
    from repro_torch.inference.engine import InjectedNoise
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import trainer as ttr
    mesh = make_mesh(setup["mesh"], ("data", "model"), "cpu")
    model = FCN3(tcfgs.fcn3_smoke(), device="cpu")
    tparams.load_into(model, setup["params"])
    tr = ttr.EnsembleTrainer(model, ttr.TrainConfig(**setup["tcfg"]),
                             setup["cw"], mesh=mesh)
    lo, hi = tr.domain.io_block
    bufs = dict(tr.domain.make_buffers(), **tr.make_loss_buffers())
    d, n = mesh.get_local_rank("data"), setup["mesh"][0]
    b = setup["batch"]["state"].shape[0] // n
    batch = {k: torch.from_numpy(v[d * b:(d + 1) * b, ..., lo:hi, :])
             for k, v in setup["batch"].items()}
    ev = tr.eval_step(bufs, batch, InjectedNoise(setup["eval_z_hat0"], []),
                      n_members=setup["eval_members"])
    return {"rows": (lo, hi), "eval": {k: float(v) for k, v in ev.items()},
            "jax_loaded": "jax" in sys.modules}


def engine_rank(rank: int, world_size: int, setup: dict) -> dict:
    """The forecast engine with ``member_axes`` on this rank's members of
    each case in ``setup["cases"]`` (its mesh, axes, members, engine
    options, requests with the reference's draws), from the given
    parameters; per case the rank's member block, its scores, final
    state and noise, and the bytes its score all-to-alls received."""
    from repro_torch.configs import fcn3 as tcfgs
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.distributed import compat
    from repro_torch.inference import params as tparams
    from repro_torch.inference import perturbations as tpert
    from repro_torch.inference.engine import (EngineConfig, ForecastEngine,
                                              InjectedNoise)
    from repro_torch.launch.mesh import make_mesh
    model = FCN3(tcfgs.fcn3_smoke(), device="cpu")
    tparams.load_into(model, setup["params"])
    bufs = model.make_buffers()
    meshes, out = {}, {}
    for name, case in setup["cases"].items():
        shape, names = case["mesh"]
        if (shape, names) not in meshes:
            meshes[shape, names] = make_mesh(shape, names, "cpu")
        eng = ForecastEngine(model, EngineConfig(
            members=case["members"], lead_chunk=2,
            spectra=case.get("spectra", False),
            perturb=tpert.PerturbationConfig(**case.get("perturb", {})),
            member_axes=case["axes"]), mesh=meshes[shape, names])
        reqs = case["requests"]
        noises = [InjectedNoise(r["z_hat0"], r["etas"], r["perturb"])
                  for r in reqs]
        compat.start_timing()
        res = eng.forecast_batched(
            bufs, [r["state0"] for r in reqs], [setup["aux"]] * len(reqs),
            noises, truths=[r["truth"] for r in reqs])
        out[name] = {"block": eng.block, "received": compat.timed_bytes(),
                     "same_group": compat.mesh_group(
                         meshes[shape, names], case["axes"]) is eng.group,
                     "results": [{"scores": {k: _np(v) for k, v in
                                             x.scores.items()},
                                  "final_state": _np(x.final_state),
                                  "final_noise": _np(x.final_noise)}
                                 for x in res]}
    out["jax_loaded"] = "jax" in sys.modules
    return out


def crps_channels_rank(rank: int, world_size: int, setup: dict) -> dict:
    """``scatter_points`` and ``dist_crps_channels`` on the card: this
    rank's member block of a seeded (E, C, S) ensemble, the CRPS kernel
    on its points; with the plain version's per-channel sums over the
    whole field on the host, and the kernel's launches."""
    from repro_torch.distributed import dist_crps
    from repro_torch.kernels.crps import ops
    from repro_torch.kernels.crps.ref import crps_fused_ref
    e, c, s = setup["shape"]
    blocks = [dist_crps.member_block(e, q, world_size)
              for q in range(world_size)]
    gen = torch.Generator().manual_seed(0)
    ens = torch.randn((e, c, s), generator=gen)
    obs = torch.randn((c, s), generator=gen)
    w = torch.rand((s,), generator=gen)
    lo, hi = blocks[rank]
    pts, (a, b) = dist_crps.scatter_points(
        ens[lo:hi].cuda(), None, [q - p for p, q in blocks])
    ops.reset_launches()
    got = dist_crps.dist_crps_channels(pts, obs[:, a:b].cuda(),
                                       w[a:b].cuda(), None)
    torch.cuda.synchronize()
    want = (crps_fused_ref(ens.reshape(e, -1), obs.reshape(-1), True)
            .reshape(c, s) * w).sum(dim=-1)
    return {"got": _np(got), "want": _np(want), "launches": ops.launches}


def domain_kinds_rank(rank: int, world_size: int, sizes: tuple) -> dict:
    """One domain-decomposed ``fcn3_smoke`` train step on a (data 1, model
    R) mesh, as ``launch/dryrun.py`` builds it: (batch, ensemble,
    rollout) = ``sizes``, random inputs on this rank's rows; returns each
    kind of collective's output bytes on this rank (``compat``'s count)."""
    from repro_torch.configs import fcn3 as tcfgs
    from repro_torch.configs.fcn3 import channel_weights
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.distributed import compat
    from repro_torch.inference.engine import GeneratorNoise
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import trainer as ttr
    b, e, t = sizes
    mesh = make_mesh((1, world_size), ("data", "model"), "cpu")
    cfg = tcfgs.fcn3_smoke()
    model = FCN3(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    tr = ttr.EnsembleTrainer(model, ttr.TrainConfig(ensemble_size=e,
                                                    rollout_steps=t),
                             channel_weights(cfg.n_levels), mesh=mesh)
    lo, hi = tr.domain.io_block
    bufs = dict(tr.domain.make_buffers(), **tr.make_loss_buffers())
    g = torch.Generator().manual_seed(1)
    batch = {"state": torch.randn((b, cfg.n_state, hi - lo, cfg.nlon),
                                  generator=g),
             "targets": torch.randn((b, t, cfg.n_state, hi - lo, cfg.nlon),
                                    generator=g),
             "aux": torch.randn((b, t, cfg.n_aux, hi - lo, cfg.nlon),
                                generator=g)}
    opt = tr.optimizer.init(dict(model.named_parameters()))
    compat.start_timing()
    tr.train_step(bufs, opt, batch, GeneratorNoise(torch.Generator()))
    return {"kinds": compat.timed_kinds(), "rows": (lo, hi),
            "jax_loaded": "jax" in sys.modules}


def moe_scatter_rank(rank: int, world_size: int, setup: dict) -> dict:
    """The MoE layer on this rank's slice of the batch over a data mesh of
    every rank (the scatter dispatch), and a decode-shaped input that
    every rank holds whole (the dense path); the routing each call saw."""
    import dataclasses
    from repro_torch.launch.mesh import data_axes, make_mesh
    from repro_torch.models import moe
    mesh = make_mesh((world_size,), ("data",), "cpu")
    group = mesh.get_group(data_axes(mesh)[0])
    out = {"jax_loaded": "jax" in sys.modules}
    params = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                  {kk: torch.from_numpy(vv) for kk, vv in v.items()})
              for k, v in setup["params"].items()}
    for cf in setup["capacity_factors"]:
        cfg = dataclasses.replace(moe.MoEConfig(**setup["cfg"]),
                                  capacity_factor=cf, dispatch="scatter",
                                  dp_axes=("data",))
        x = setup["x"]
        b = x.shape[0] // world_size
        mine = torch.from_numpy(x[rank * b:(rank + 1) * b])
        seen = []
        g = moe.scatter_group(cfg, group, x.shape[0], x.shape[1])
        with moe.observe(seen.append):
            y, aux = moe.apply_moe(params, cfg, mine, g)
        r = seen[0]
        out[cf] = {"scatter": g is not None, "y": _np(y),
                   "aux": {k: float(v) for k, v in aux.items()},
                   "gate_idx": _np(r.gate_idx), "keep": _np(r.keep),
                   "ranks": r.ranks, "slot": _np(r.slot)}
        small = torch.from_numpy(setup["small"])
        g = moe.scatter_group(cfg, group, *small.shape[:2])
        seen = []
        with moe.observe(seen.append):
            y, _ = moe.apply_moe(params, cfg, small, g)
        out[cf]["small"] = {"scatter": g is not None, "y": _np(y),
                            "dense": seen[0].dispatch is not None}
    return out


def channel_rank(rank: int, world_size: int, setup: dict) -> dict:
    """One ``fcn3_smoke`` loss, gradient and Adam step on a (data, model)
    mesh of ``setup["mesh"]`` with the trainer's ``placement`` (channel,
    or ensemble parallelism whose ensemble may not split), from the given
    parameters (rank 0's: the others start from halved ones), global
    batch and noise draws; the gradients and the updated parameters
    gathered whole, this rank's blocks, and with ``ckpt`` a checkpoint
    written whole by rank 0."""
    from repro_torch.configs import fcn3 as tcfgs
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.distributed import compat, sharding
    from repro_torch.inference import params as tparams
    from repro_torch.inference.engine import InjectedNoise
    from repro_torch.launch.mesh import make_toy_mesh
    from repro_torch.train import checkpoint as tckpt
    from repro_torch.train import trainer as ttr
    mesh = make_toy_mesh(*setup["mesh"])
    model = FCN3(tcfgs.fcn3_smoke(), device="cpu")
    tparams.load_into(model, setup["params"])
    if rank:
        for p in model.parameters():
            p.detach().mul_(0.5)
    tr = ttr.EnsembleTrainer(model, ttr.TrainConfig(**setup["tcfg"]),
                             setup["cw"], mesh=mesh,
                             placement=setup["placement"])
    bufs = dict(model.make_buffers(), **tr.make_loss_buffers())
    n_data, d = setup["mesh"][0], mesh.get_local_rank("data")
    b = setup["batch"]["state"].shape[0] // n_data
    batch = {k: torch.from_numpy(v[d * b:(d + 1) * b]) for k, v in
             setup["batch"].items()}

    def noise():
        return InjectedNoise(setup["z_hat0"], setup["etas"])

    compat.start_timing()
    loss, aux, grads = tr.loss_and_grads(bufs, batch, noise())
    kinds = compat.timed_kinds()
    norm = float(tr.grad_norm(grads))
    blocks = {k: _np(g) for k, g in grads.items() if k in tr.split}
    specs = tr.channel.specs if tr.channel is not None else {}
    whole = sharding.gather_blocks(grads, specs, mesh)
    state = tr.optimizer.init(dict(model.named_parameters()))
    state, diag = tr.train_step(bufs, state, batch, noise())
    params, opt = tr.whole_state(state)
    out = {"loss": float(loss), "aux": {k: float(v) for k, v in aux.items()},
           "grads": {k: _np(v) for k, v in whole.items()},
           "blocks": blocks, "norm": norm,
           "step_norm": float(diag["grad_norm"]), "kinds": kinds,
           "params": {k: _np(p) for k, p in params.items()},
           "local_params": {k: _np(p) for k, p in model.named_parameters()
                            if k in tr.split},
           "split": sorted(tr.split), "whole_members": tr.whole_members,
           "jax_loaded": "jax" in sys.modules}
    if setup.get("ckpt") and rank == 0:
        out["ckpt"] = tckpt.save_checkpoint(setup["ckpt"], 1, params, opt)
    return out


def moe_placement_rank(rank: int, world_size: int, setup: dict) -> dict:
    """A smoke MoE LM's logits, aux, loss and gradients on a (data 2,
    model 2) mesh, this rank's slice of the batch: with whole experts,
    then with the experts placed over the model axis
    (``LM.place_experts``; the placed stacks' gradients gathered whole),
    in ``setup["dispatch"]``; the placed run's collective bytes and kept
    pairs."""
    import dataclasses
    from repro_torch.configs import archs
    from repro_torch.distributed import compat, sharding
    from repro_torch.launch.mesh import make_toy_mesh
    from repro_torch.models import moe
    from repro_torch.models.params import lm_params_from_numpy
    from repro_torch.models.transformer import LM
    from repro_torch.train import lm as lmtrain
    mesh = make_toy_mesh(2, 2)
    data, experts = mesh.get_group("data"), mesh.get_group("model")
    cfg = archs.smoke_config(setup["arch"])
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch=setup["dispatch"], dp_axes=("data",)))
    tokens = setup["tokens"]
    b = tokens.shape[0] // 2
    d = mesh.get_local_rank("data")
    batch = {"tokens": torch.from_numpy(tokens[d * b:(d + 1) * b]).long(),
             "labels": torch.from_numpy(tokens[d * b:(d + 1) * b]).long()}
    group = moe.scatter_group(cfg.moe, data, *tokens.shape)
    out = {"jax_loaded": "jax" in sys.modules, "scatter": group is not None}
    for name in ("whole", "placed"):
        model = LM(cfg, device="cpu")
        model.load_state_dict(lm_params_from_numpy(setup["params"], cfg))
        eg = None
        if name == "placed":
            out["placed_names"] = model.place_experts(mesh)
            eg = experts
        kept = []
        compat.start_timing()
        with torch.no_grad(), moe.observe(
                lambda r: kept.append(int(r.keep.sum()))):
            logits, aux = model.apply_train(batch["tokens"],
                                            moe_group=group,
                                            expert_group=eg)
        kinds = compat.timed_kinds()
        loss, laux, grads = lmtrain.loss_and_grads(model, batch, data, group,
                                                   eg)
        norm = lmtrain.grad_norm(model, grads, eg)
        if name == "placed":
            specs = sharding.sanitize_specs(
                mesh, sharding.lm_expert_specs(
                    cfg, {k: torch.empty(s, device="meta") for k, s in
                          out["whole"]["shapes"].items()}),
                {k: torch.empty(s, device="meta") for k, s in
                 out["whole"]["shapes"].items()})
            grads = sharding.gather_blocks(grads, specs, mesh)
        out[name] = {"logits": _np(logits),
                     "aux": {k: float(v) for k, v in aux.items()},
                     "loss": float(loss), "norm": float(norm),
                     "grads": {k: _np(g) for k, g in grads.items()},
                     "shapes": {k: tuple(p.shape)
                                for k, p in model.named_parameters()},
                     "kinds": kinds, "kept": kept}
    return out
