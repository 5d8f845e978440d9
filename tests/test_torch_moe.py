"""The port's mixture of experts (``repro_torch.models.moe``) and the MoE
LM family against the JAX package.

The layer alone at smoke widths (D 128, F 64, E 4, top-2, 1 shared),
the JAX ``init_moe`` weights carried across: the routing first (the
experts of every pair and the kept mask must be equal, so that a routing
flip fails here and is never absorbed by a tolerance), then the output
and the aux, at ``capacity_factor`` 1.25 (pairs drop) and 2.0.  The
scatter dispatch over a gloo world of 4 ranks (rank bodies in
``tests/_torch_dist_workers.py``) against JAX's ``apply_moe_scatter`` on
a (4, 2) mesh of host devices, run in a subprocess as
``tests/test_perf_paths.py`` runs it; the decode-shaped input takes the
dense path on both sides.  Then both smoke LMs (deepseek-v2: 1 dense + 2
MoE layers; llama4: 2 units of a dense and a MoE layer): logits and aux
against ``LM.apply_train``, 4 decode steps and the caches against
``LM.decode_step``, the parameter round trip, the config modules and the
LM CLI.  Bar: rtol 1e-4, atol 1e-5 (``tests/test_kernel_dispatch.py``).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import TORCH_THREADS, few_torch_threads  # noqa: F401

import _torch_dist_workers as workers
from repro.configs import archs as jarchs
from repro.models import common as jcm
from repro.models import moe as jmoe
from repro.models.transformer import LM as JaxLM
from repro.train.checkpoint import _flatten_with_paths
from repro_torch.configs import archs as tarchs
from repro_torch.distributed.world import run_world
from repro_torch.models import moe as tmoe
from repro_torch.models.params import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models.transformer import LM

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")
#: the layer's smoke widths
CFG = dict(d_model=128, d_ff=64, n_experts=4, top_k=2, n_shared=1,
           shared_d_ff=64)
CAPACITY_FACTORS = (1.25, 2.0)
RANKS = 4


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tokens_x(seed, shape):
    """Hidden states with a common direction added, so that the router
    favours some experts and pairs overflow their capacity at 1.25."""
    common = 2.0 * _normal(seed + 100, shape[-1:])
    return (_normal(seed, shape) + common).astype(np.float32)


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _to_np(tree):
    return {k: _to_np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def layer_params():
    return _to_np(jmoe.init_moe(jax.random.PRNGKey(0),
                                jmoe.MoEConfig(**CFG)))


def _jax_routing(params, cfg, xt):
    """The JAX package's routing (``apply_moe``, models/moe.py:222-236),
    in its own ops: the experts of each pair and the kept mask."""
    e, k = cfg.n_experts, cfg.top_k
    logits = jcm.linear(params["router"], xt).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(gate_idx, e, dtype=jnp.float32)
    pos_in_expert = (jnp.cumsum(onehot.reshape(-1, e), axis=0)
                     .reshape(xt.shape[0], k, e) - onehot)
    pos = jnp.einsum("tke,tke->tk", pos_in_expert, onehot)
    keep = pos < jmoe._capacity(xt.shape[0], cfg)
    return np.asarray(gate_idx), np.asarray(keep)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_dense_dispatch_matches_jax(layer_params, cf):
    jcfg = jmoe.MoEConfig(**CFG, capacity_factor=cf)
    tcfg = tmoe.MoEConfig(**CFG, capacity_factor=cf)
    x = _tokens_x(1, (2, 24, CFG["d_model"]))
    want, waux = jmoe.apply_moe(jax.tree.map(jnp.asarray, layer_params),
                                jcfg, jnp.asarray(x))
    seen = []
    with tmoe.observe(seen.append):
        got, gaux = tmoe.apply_moe(_to_torch(layer_params), tcfg,
                                   torch.from_numpy(x))
    gi, keep = _jax_routing(layer_params, jcfg, x.reshape(48, -1))
    np.testing.assert_array_equal(seen[0].gate_idx.numpy(), gi)
    np.testing.assert_array_equal(seen[0].keep.numpy(), keep)
    if cf == 1.25:     # the premise: pairs do drop at this capacity
        assert not keep.all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("lb_loss", "router_entropy"):
        np.testing.assert_allclose(float(gaux[key]), float(waux[key]), **TOL)


@pytest.mark.parametrize("tokens,cf", [(1, 1.25), (4, 1.25), (48, 1.25),
                                       (48, 2.0), (4096, 1.25),
                                       (2048, 1.25), (256, 80.0)])
def test_capacity_matches_jax(tokens, cf):
    for e, k in ((4, 2), (160, 6), (128, 1)):
        kw = dict(d_model=8, d_ff=8, n_experts=e, top_k=k,
                  capacity_factor=cf)
        assert tmoe._capacity(tokens, tmoe.MoEConfig(**kw)) == \
            jmoe._capacity(tokens, jmoe.MoEConfig(**kw))


def test_dense_dispatch_holds_its_invariants(layer_params):
    # every kept pair holds exactly one slot, no slot holds two pairs,
    # and the kept count is what the host recomputes from gate_idx
    cfg = tmoe.MoEConfig(**CFG, capacity_factor=1.25)
    seen = []
    with tmoe.observe(seen.append):
        tmoe.apply_moe(_to_torch(layer_params), cfg,
                       torch.from_numpy(_tokens_x(2, (3, 40, 128))))
    r = seen[0]
    disp = r.dispatch
    assert not r.keep.all()
    assert set(torch.unique(disp).tolist()) <= {0.0, 1.0}
    assert float(disp.sum(0).max()) <= 1.0
    t_idx, k_idx = torch.nonzero(r.keep, as_tuple=True)
    assert bool((disp[t_idx, r.gate_idx[t_idx, k_idx],
                      r.pos[t_idx, k_idx]] == 1).all())
    assert float(disp.sum()) == int(r.keep.sum())
    counts = np.bincount(r.gate_idx.numpy().reshape(-1),
                         minlength=cfg.n_experts)
    assert int(r.keep.sum()) == int(np.minimum(counts, r.cap).sum())


def test_local_dispatch_ranks_ties_in_token_order():
    # every token routed to the same two experts: a stable sort ranks the
    # pairs in token order within an expert, as the dense cumulative sum
    gate_idx = torch.tensor([[1, 0]] * 6 + [[0, 2]] * 3)
    xt = torch.arange(9 * 4, dtype=torch.float32).reshape(9, 4)
    buf, flat_e, slot, keep, pos = tmoe._local_dispatch(xt, gate_idx, 3, 5)
    e0 = (flat_e == 0).nonzero()[:, 0]
    assert pos[e0].tolist() == list(range(9))
    assert keep.sum() == 5 + 5 + 3
    assert torch.equal(buf[0], xt[:5])           # the first five tokens
    assert torch.equal(buf[2, :3], xt[6:9])
    assert bool((slot[~keep] == 5).all())


def test_init_moe_draws_in_place_with_the_jax_distributions():
    cfg = tmoe.MoEConfig(d_model=256, d_ff=128, n_experts=8, top_k=2,
                         n_shared=2)
    layer = tmoe.MoE(cfg, device="cpu")
    ptrs = {n: p.data_ptr() for n, p in layer.named_parameters()}
    tmoe.init_moe(layer, torch.Generator().manual_seed(0))
    assert {n: p.data_ptr() for n, p in layer.named_parameters()} == ptrs
    want = {"router": 256, "w_gate": 256, "w_up": 256, "w_down": 128,
            "shared.w_gate": 256, "shared.w_up": 256, "shared.w_down": 256}
    shapes = _to_np(jax.tree.map(
        lambda a: np.zeros(a.shape),
        jmoe.init_moe(jax.random.PRNGKey(0), jmoe.MoEConfig(
            **dataclasses.asdict(cfg)))))
    for name, p in layer.named_parameters():
        assert abs(float(p.std()) * want[name] ** 0.5 - 1) < 0.05, name
        top, _, sub = name.partition(".")
        assert tuple(p.shape) == (shapes[top][sub] if sub
                                  else shapes[top]).shape, name


# ---------------------------------------------------------------------------
# the scatter dispatch over 4 ranks
# ---------------------------------------------------------------------------

_JAX_SCATTER = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import contextlib, dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from repro.models import moe
src = np.load(sys.argv[1], allow_pickle=True)
setup = src["setup"].item()
params = jax.tree.map(jnp.asarray, setup["params"])
mesh = jax.make_mesh((4, 2), ("data", "model"))
if hasattr(jax, "set_mesh"):
    jax.set_mesh(mesh)
    ctx = contextlib.nullcontext()
else:
    ctx = mesh
out = {}
with ctx:
    for cf in setup["capacity_factors"]:
        cfg = moe.MoEConfig(**setup["cfg"], capacity_factor=cf,
                            dispatch="scatter", dp_axes=("data",))
        y, aux = jax.jit(lambda p, x: moe.apply_moe(p, cfg, x))(
            params, jnp.asarray(setup["x"]))
        ys, _ = jax.jit(lambda p, x: moe.apply_moe(p, cfg, x))(
            params, jnp.asarray(setup["small"]))
        dense = dataclasses.replace(cfg, dispatch="dense")
        yd, _ = jax.jit(lambda p, x: moe.apply_moe(p, dense, x))(
            params, jnp.asarray(setup["small"]))
        out[str(cf)] = {"y": np.asarray(y), "small": np.asarray(ys),
                        "small_dense": np.asarray(yd),
                        "aux": {k: float(v) for k, v in aux.items()}}
np.save(sys.argv[2], out, allow_pickle=True)
print("JAX_SCATTER_OK")
"""


@pytest.fixture(scope="module")
def scatter(layer_params, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_scatter")
    setup = {"params": layer_params, "cfg": CFG,
             "capacity_factors": CAPACITY_FACTORS,
             "x": _tokens_x(3, (8, 16, CFG["d_model"])),
             "small": _normal(4, (1, 1, CFG["d_model"]))}
    np.savez(tmp / "in.npz", setup=np.array(setup, dtype=object))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _JAX_SCATTER,
                           str(tmp / "in.npz"), str(tmp / "out.npy")],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert "JAX_SCATTER_OK" in proc.stdout, proc.stderr[-3000:]
    want = np.load(tmp / "out.npy", allow_pickle=True).item()
    got = run_world(workers.moe_scatter_rank, RANKS, (setup,),
                    timeout=120.0, threads=1)
    return setup, want, got


def test_scatter_ranks_import_no_jax(scatter):
    assert not any(r["jax_loaded"] for r in scatter[2])


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_scatter_routing_matches_jax_rank_by_rank(scatter, cf):
    # JAX's rank-local dispatch (moe._local_dispatch) on each rank's
    # tokens and the JAX router's choices
    setup, _, got = scatter
    params = setup["params"]
    jcfg = jmoe.MoEConfig(**CFG, capacity_factor=cf)
    x = setup["x"]
    b = x.shape[0] // RANKS
    for rank, r in enumerate(got):
        assert r[cf]["scatter"] and r[cf]["ranks"] == RANKS
        xt = x[rank * b:(rank + 1) * b].reshape(-1, CFG["d_model"])
        gi, _ = _jax_routing(params, jcfg, xt)
        np.testing.assert_array_equal(r[cf]["gate_idx"], gi)
        cap = jmoe._capacity(xt.shape[0], jcfg)
        _, _, slot, keep = jmoe._local_dispatch(
            jnp.asarray(xt), jnp.asarray(gi), CFG["n_experts"], cap)
        np.testing.assert_array_equal(r[cf]["keep"].reshape(-1),
                                      np.asarray(keep))
        np.testing.assert_array_equal(r[cf]["slot"], np.asarray(slot))
    if cf == 1.25:
        assert not all(r[cf]["keep"].all() for r in got)


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_scatter_output_and_aux_match_jax(scatter, cf):
    setup, want, got = scatter
    w = want[str(cf)]
    y = np.concatenate([r[cf]["y"] for r in got])
    np.testing.assert_allclose(y, w["y"], **TOL)
    for r in got:
        for key, val in w["aux"].items():
            np.testing.assert_allclose(r[cf]["aux"][key], val, **TOL)


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_decode_shaped_input_takes_the_dense_path(scatter, cf):
    _, want, got = scatter
    w = want[str(cf)]
    np.testing.assert_allclose(w["small"], w["small_dense"], **TOL)
    for r in got:
        s = r[cf]["small"]
        assert not s["scatter"] and s["dense"]
        np.testing.assert_allclose(s["y"], w["small"], **TOL)


# ---------------------------------------------------------------------------
# the MoE LMs
# ---------------------------------------------------------------------------

_JAX_LMS: dict = {}


def _jax_lm(arch):
    if arch not in _JAX_LMS:
        model = JaxLM(jarchs.smoke_config(arch))
        params = model.init(jax.random.PRNGKey(0))
        flat = {k: np.asarray(v)
                for k, v in _flatten_with_paths(params).items()}
        _JAX_LMS[arch] = model, params, flat
    return _JAX_LMS[arch]


def _port(arch):
    cfg = tarchs.smoke_config(arch)
    model = LM(cfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(_jax_lm(arch)[2], cfg),
                          strict=True)
    return model


def _tokens(arch, shape, seed):
    cfg = tarchs.smoke_config(arch)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_of_the_smoke_lms(arch):
    port = _port(arch)
    cfg = port.cfg
    if cfg.moe_every > 1:      # llama4: 2 units of a dense and a MoE layer
        assert (port.n_units, len(port.unit_dense[0]), len(port.layers),
                hasattr(port, "dense_layers")) == (2, 1, 2, False)
    else:                      # deepseek: 1 dense + 2 MoE layers
        assert (len(port.dense_layers), len(port.layers)) == (1, 2)
    assert all(isinstance(layer.ffn, tmoe.MoE) for layer in port.layers)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_aux_match_jax(arch):
    model, params, _ = _jax_lm(arch)
    tok = _tokens(arch, (2, 24), 30)
    want, waux = model.apply_train(params, jnp.asarray(tok))
    got, gaux = _port(arch).apply_train(torch.from_numpy(tok).long())
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sorted(gaux) == sorted(waux)
    for key in waux:
        np.testing.assert_allclose(float(gaux[key]), float(waux[key]), **TOL)
    assert float(gaux["lb_loss"]) > 0
    # plain forward: the logits alone
    np.testing.assert_array_equal(
        _port(arch)(torch.from_numpy(tok).long()).numpy(), got.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_caches_match_jax(arch):
    model, params, _ = _jax_lm(arch)
    port = _port(arch)
    tok = _tokens(arch, (2, 4), 31)
    jcache, tcache = model.init_cache(2, 8), port.init_cache(2, 8)
    jl, tl = _leaves(jcache), _leaves(tcache)
    assert sorted(tl) == sorted(jl)
    for t in range(4):
        want, jcache = model.decode_step(params, jnp.asarray(tok[:, t:t + 1]),
                                         jcache, jnp.int32(t))
        got, tcache = port.decode_step(torch.from_numpy(tok[:, t:t + 1])
                                       .long(), tcache, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jl, tl = _leaves(jcache), _leaves(tcache)
    for key in jl:
        assert tuple(tl[key].shape) == jl[key].shape, key
        np.testing.assert_allclose(tl[key].numpy(), np.asarray(jl[key]),
                                   **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_round_trip(arch):
    flat = _jax_lm(arch)[2]
    cfg = tarchs.smoke_config(arch)
    port = _port(arch)
    back = lm_params_to_numpy(port.state_dict(), cfg)
    assert sorted(back) == sorted(flat)
    for key, val in flat.items():
        np.testing.assert_array_equal(back[key], val)
    assert port.param_count() == sum(v.size for v in flat.values())
    sd = lm_params_from_numpy(flat, cfg)
    if cfg.moe_every > 1:
        assert flat["unit_dense/attn/wq"].shape[:2] == (2, 1)
        assert {"unit_dense.1.0.attn.wq", "layers.1.ffn.shared.w_up",
                "layers.0.ffn.w_down"} <= set(sd)
    else:
        assert {"dense_layers.0.ffn.w_gate", "layers.1.ffn.router",
                "layers.0.attn.w_dkv"} <= set(sd)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_every_parameter(arch):
    cfg = tarchs.smoke_config(arch)
    model = LM(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    sd = lm_params_from_numpy(_jax_lm(arch)[2], cfg)
    assert sorted(model.state_dict()) == sorted(sd)
    for name, p in model.state_dict().items():
        assert tuple(p.shape) == tuple(sd[name].shape), name
        if name.rsplit(".", 1)[-1].startswith(("w", "router", "embed",
                                               "lm_head")):
            assert float(p.abs().max()) > 0, name


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_decode_when_nothing_drops(arch):
    # at capacity_factor n_experts / top_k the capacity covers every
    # token, so the prefill and the decode steps route every pair
    port = _port(arch)
    moe = port.cfg.moe
    port.cfg = dataclasses.replace(port.cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.top_k))
    tok = torch.from_numpy(_tokens(arch, (2, 16), 32)).long()
    full = port(tok)
    cache = port.init_cache(2, 16)
    for t in range(16):
        step, cache = port.decode_step(tok[:, t:t + 1], cache, t)
        torch.testing.assert_close(step[:, 0], full[:, t], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_of_the_port_match_jax(arch):
    from jax.sharding import PartitionSpec

    from repro.distributed import sharding as jsharding
    from repro_torch.distributed import sharding as tsharding
    _, params, _ = _jax_lm(arch)
    jcfg, tcfg = jarchs.smoke_config(arch), tarchs.smoke_config(arch)
    flat = jax.tree_util.tree_flatten_with_path(
        jsharding.lm_param_specs(jcfg, params),
        is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}
    port = lm_params_to_numpy(_port(arch).state_dict(), tcfg)
    assert tsharding.lm_param_specs(tcfg, port) == want


def test_an_invalid_moe_stack_is_refused():
    cfg = dataclasses.replace(tarchs.smoke_config(ARCHS[1]), n_layers=3)
    with pytest.raises(ValueError, match="moe_every"):
        LM(cfg, device="cpu")


# ---------------------------------------------------------------------------
# configs and the CLI
# ---------------------------------------------------------------------------

def test_full_config_widths():
    from repro_torch.configs import deepseek_v2_236b, llama4_maverick_400b_a17b
    ds = deepseek_v2_236b.config()
    assert (ds.n_layers, ds.n_dense_layers, ds.d_model, ds.n_heads,
            ds.kv_lora_rank, ds.q_lora_rank, ds.padded_vocab) == (
        60, 1, 5120, 128, 512, 1536, 102400)
    assert (ds.moe.n_experts, ds.moe.d_ff, ds.moe.top_k,
            ds.moe.shared_width) == (160, 1536, 6, 3072)
    ll = llama4_maverick_400b_a17b.config()
    assert (ll.n_layers, ll.moe_every, ll.d_ff, ll.n_heads, ll.n_kv_heads,
            ll.padded_vocab) == (48, 2, 16384, 40, 8, 202240)
    assert (ll.moe.n_experts, ll.moe.d_ff, ll.moe.top_k,
            ll.moe.shared_width) == (128, 8192, 1, 8192)


def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS=str(TORCH_THREADS))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.lm",
                           *args], capture_output=True, text=True, env=env,
                          timeout=120)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape,phase", [("prefill_32k", "[prefill]"),
                                         ("decode_32k", "[decode]")])
def test_lm_cli_runs_the_moe_architectures_on_cpu(arch, shape, phase):
    proc = _run_cli("--arch", arch, "--smoke", "--shape", shape,
                    "--seq-len", "40", "--decode-steps", "3", "--device",
                    "cpu")
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(phase)]
    assert len(lines) == 1, proc.stdout
    if phase == "[prefill]":
        assert "logits=(2, 40, 256)" in lines[0]
        share = float(lines[0].split("moe_drop_share=")[1].split()[0])
        assert 0.0 <= share < 1.0


def test_build_model_cuts_depth_to_a_valid_moe_stack():
    from repro_torch.launch import lm as lm_mod
    m = lm_mod.build_model("llama4-maverick-400b-a17b", smoke=True,
                           device="cpu", layers=2)
    assert (m.cfg.n_layers, m.n_units) == (2, 1)
    m = lm_mod.build_model("deepseek-v2-236b", smoke=True, device="cpu",
                           layers=2)
    assert (m.cfg.n_layers, len(m.dense_layers), len(m.layers)) == (2, 1, 1)
    for arch, layers in (("llama4-maverick-400b-a17b", 3),
                         ("deepseek-v2-236b", 1)):
        with pytest.raises(ValueError, match="MoE stack"):
            lm_mod.build_model(arch, smoke=True, device="cpu", layers=layers)


def test_moe_modules_import_no_jax():
    code = ("import sys, repro_torch.models.moe, repro_torch.launch.lm, "
            "repro_torch.configs.deepseek_v2_236b, "
            "repro_torch.configs.llama4_maverick_400b_a17b; "
            "assert 'jax' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_observe_sees_every_moe_layer_in_order():
    port = _port(ARCHS[0])
    seen = []
    with tmoe.observe(seen.append):
        port(torch.from_numpy(_tokens(ARCHS[0], (1, 12), 33)).long())
    assert len(seen) == 2 and all(r.gate_idx.shape == (12, 2) for r in seen)
    assert json.dumps([r.cap for r in seen]) == "[8, 8]"


# ---------------------------------------------------------------------------
# the expert placement over the model axis
# ---------------------------------------------------------------------------

PLACED_TOKENS = (4, 32)        # the global batch, split over 2 data ranks


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_specs_are_the_jax_rules_expert_entries(arch):
    from jax.sharding import PartitionSpec

    from repro.distributed import sharding as jsharding
    from repro_torch.distributed import sharding as tsharding
    _, params, _ = _jax_lm(arch)
    jcfg, tcfg = jarchs.smoke_config(arch), tarchs.smoke_config(arch)
    flat = jax.tree_util.tree_flatten_with_path(
        jsharding.lm_param_specs(jcfg, params),
        is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    full = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}
    port = lm_params_to_numpy(_port(arch).state_dict(), tcfg)
    got = tsharding.lm_expert_specs(tcfg, port)
    stacks = {p for p in port if p.rsplit("/", 1)[-1] in
              ("w_gate", "w_up", "w_down") and port[p].ndim >= 3
              and tcfg.moe.n_experts in port[p].shape[-3:-2]}
    assert stacks
    for p, spec in got.items():
        # the expert dim keeps JAX's model entry, every other one is None
        want = tuple(e if p in stacks and i == len(spec) - 3 else None
                     for i, e in enumerate(full[p]))
        assert spec == want, p
        assert ("model" in spec) == (p in stacks)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("dense", "scatter")],
                ids=lambda p: f"{p[0].split('-')[0]}-{p[1]}")
def placed(request):
    arch, dispatch = request.param
    setup = {"arch": arch, "dispatch": dispatch,
             "params": _jax_lm(arch)[2],
             "tokens": _tokens(arch, PLACED_TOKENS, 41)}
    res = run_world(workers.moe_placement_rank, RANKS, (setup,),
                    timeout=120.0, threads=1)
    return setup, res


_JAX_PLACED = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import contextlib, dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import archs
from repro.models.transformer import LM
from repro.train.checkpoint import _flatten_with_paths
src = np.load(sys.argv[1], allow_pickle=True)
setup = src["setup"].item()
# Auto axes: the LM's layer scan keeps its carry's type when the scatter
# hands back its data-split output
kw = ({"axis_types": (jax.sharding.AxisType.Auto,) * 2}
      if hasattr(jax.sharding, "AxisType") else {})
mesh = jax.make_mesh((2, 2), ("data", "model"), **kw)
if hasattr(jax, "set_mesh"):
    jax.set_mesh(mesh)
    ctx = contextlib.nullcontext()
else:
    ctx = mesh
flat = lambda t: {k: np.asarray(v) for k, v in _flatten_with_paths(t).items()}
out = {}
with ctx:
    for arch, tokens in setup["tokens"].items():
        base = archs.smoke_config(arch)
        params = LM(base).init(jax.random.PRNGKey(0))
        b = tokens.shape[0] // 2
        for dispatch in ("dense", "scatter"):
            model = LM(dataclasses.replace(base, moe=dataclasses.replace(
                base.moe, dispatch=dispatch, dp_axes=("data",))))
            fwd = jax.jit(model.apply_train)
            grad = jax.jit(jax.value_and_grad(model.loss, has_aux=True))
            # dense: each data rank's slice on its own, the gradients
            # averaged; scatter: the global batch, its aux over both slices
            parts = ([tokens[d * b:(d + 1) * b] for d in range(2)]
                     if dispatch == "dense" else [tokens])
            res = []
            for tok in parts:
                tok = jnp.asarray(tok)
                logits, aux = fwd(params, tok)
                (loss, _), g = grad(params, {"tokens": tok, "labels": tok})
                res.append(dict(logits=np.asarray(logits),
                                aux={k: float(v) for k, v in aux.items()},
                                loss=float(loss), grads=flat(g)))
            out[arch, dispatch] = dict(
                logits=np.concatenate([r["logits"] for r in res]),
                aux=[r["aux"] for r in res],
                loss=float(np.mean([r["loss"] for r in res])),
                grads={k: np.mean([r["grads"][k] for r in res], axis=0)
                       for k in res[0]["grads"]})
np.save(sys.argv[2], out, allow_pickle=True)
print("JAX_PLACED_OK")
"""


@pytest.fixture(scope="module")
def jax_placed(tmp_path_factory):
    """JAX's ``LM`` on the placed runs' tokens, on a (2, 2) mesh of host
    devices: logits, aux, loss and gradients per (arch, dispatch)."""
    tmp = tmp_path_factory.mktemp("moe_placed")
    setup = {"tokens": {a: _tokens(a, PLACED_TOKENS, 41) for a in ARCHS}}
    np.savez(tmp / "in.npz", setup=np.array(setup, dtype=object))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _JAX_PLACED,
                           str(tmp / "in.npz"), str(tmp / "out.npy")],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert "JAX_PLACED_OK" in proc.stdout, proc.stderr[-3000:]
    return np.load(tmp / "out.npy", allow_pickle=True).item()


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_placed_experts_match_whole_experts(placed):
    setup, res = placed
    cfg = tarchs.smoke_config(setup["arch"])
    e = cfg.moe.n_experts
    for r in res:
        assert not r["jax_loaded"]
        assert r["scatter"] == (setup["dispatch"] == "scatter")
        w, p = r["whole"], r["placed"]
        # each rank holds E/2 experts of every stack
        assert r["placed_names"] and all(
            p["shapes"][k][-3] == e // 2 for k in r["placed_names"])
        assert _rel(p["logits"], w["logits"]) <= 1e-5
        for k in w["aux"]:
            np.testing.assert_allclose(p["aux"][k], w["aux"][k], rtol=1e-5)
        np.testing.assert_allclose(p["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(p["norm"], w["norm"], rtol=1e-5)
        for k, g in w["grads"].items():
            np.testing.assert_allclose(p["grads"][k], g, rtol=2e-3,
                                       atol=2e-4, err_msg=k)
        assert p["kept"] == w["kept"]


def test_placed_experts_match_one_process_on_each_slice(placed):
    # a rank's capacity is its slice's (both dispatches), so one process
    # with whole experts on the slice routes and drops the same pairs;
    # the scatter dispatch's aux are means over both slices' tokens
    setup, res = placed
    port = _port(setup["arch"])
    b = PLACED_TOKENS[0] // 2
    for rank, r in enumerate(res):
        d = rank // 2
        tok = torch.from_numpy(setup["tokens"][d * b:(d + 1) * b]).long()
        with torch.no_grad():
            logits, aux = port.apply_train(tok)
        assert _rel(r["placed"]["logits"], logits.numpy()) <= 1e-5
        for k in aux if setup["dispatch"] == "dense" else ():
            np.testing.assert_allclose(r["placed"]["aux"][k], float(aux[k]),
                                       rtol=1e-5)


def test_placed_experts_match_jax(placed, jax_placed):
    # every rank's placed logits and aux against JAX's LM on its slice
    # (dense) or on the global batch with the slices over the data axis
    # (scatter: the aux are means over both slices), and the gathered
    # gradients of the step (averaged over the data ranks) against JAX's
    setup, res = placed
    want = jax_placed[setup["arch"], setup["dispatch"]]
    cfg = tarchs.smoke_config(setup["arch"])
    b = PLACED_TOKENS[0] // 2
    for rank, r in enumerate(res):
        d = rank // 2
        p = r["placed"]
        np.testing.assert_allclose(p["logits"],
                                   want["logits"][d * b:(d + 1) * b], **TOL)
        waux = want["aux"][d if setup["dispatch"] == "dense" else 0]
        assert sorted(p["aux"]) == sorted(waux)
        for k, v in waux.items():
            np.testing.assert_allclose(p["aux"][k], v, **TOL, err_msg=k)
        np.testing.assert_allclose(p["loss"], want["loss"], rtol=1e-4)
        got = lm_params_to_numpy(
            {k: torch.from_numpy(g) for k, g in p["grads"].items()}, cfg)
        assert sorted(got) == sorted(want["grads"])
        for k, g in want["grads"].items():
            np.testing.assert_allclose(got[k], g, rtol=2e-3, atol=2e-4,
                                       err_msg=k)


def test_placement_gathers_the_expert_outputs_over_the_model_axis(placed):
    # one all-gather of (E, cap, D) fp32 outputs a MoE layer: the tokens
    # are replicated over the model axis, so no all-to-all
    setup, res = placed
    cfg = tarchs.smoke_config(setup["arch"])
    b = PLACED_TOKENS[0] // 2
    cap = tmoe._capacity(b * PLACED_TOKENS[1], cfg.moe)
    for r in res:
        kinds = r["placed"]["kinds"]
        n_moe = len(r["placed"]["kept"])
        assert kinds["all_gather"] == n_moe * (
            cfg.moe.n_experts * cap * cfg.d_model * 4)
        assert kinds["all_to_all"] == 0 and kinds["all_reduce"] == (
            0 if setup["dispatch"] == "dense"
            else n_moe * (2 * cfg.moe.n_experts + 1) * 4)
        assert r["whole"]["kinds"]["all_gather"] == 0
