"""LM training in the port (``LM.loss``, ``train/lm.py``, the SSD
backward path) against the JAX package, on the CPU.

(i) For every architecture at its smoke config (batch 2 x 32, dense
dispatch), with ``remat`` on and off: ``LM.loss`` and the gradient of
every parameter against ``jax.value_and_grad(model.loss, has_aux=True)``
on the same weights (``lm_params_from_numpy``) and inputs (numpy seeds).
(ii) The port's Adam update against the reference's ``opt.update`` on the
same gradients, and one train step lowering the loss.  (iii) Autograd of
the kernel path's chunked scan (``ssd_chunked_kernel``: on CPU tensors the
plain versions, differentiated by autograd) against autograd of the plain
einsum scan and against JAX's, with a chunk whose |dA| sum passes 88; the
plain backward wrappers against autograd.  (iv) ``cross_entropy_loss``
with ``ignore_index``.  (v) ``python -m repro_torch.launch.smoketest`` and
the dry run's ``train_4k`` cases.  (vi) The new modules import no JAX.

Bars: the loss at rtol 1e-4; gradients at rtol 2e-3 / atol 2e-4
(``tests/test_kernel_dispatch.py``'s gradient bar); Adam at rtol 1e-5.
"""

import dataclasses
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

from repro.configs import archs as jarchs
from repro.models import common as jcm
from repro.models import ssm as jssm
from repro.models.transformer import LM as JaxLM
from repro.optim import adam as jadam
from repro.train.checkpoint import _flatten_with_paths
from repro_torch.configs import archs as tarchs
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.launch import dryrun
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcm
from repro_torch.models import ssm as tssm
from repro_torch.models.params import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models.transformer import LM
from repro_torch.optim import adam as tadam
from repro_torch.train import lm as lmtrain

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
ADAM_RTOL = 1e-5
ARCHS = sorted(tarchs.ARCHS)
BATCH, SEQ = 2, 32


def _rng(seed):
    return np.random.default_rng(seed)


def _batch(arch, seed=0):
    """Tokens and labels (one label ignored), with the patches or frames
    the family takes, as numpy."""
    cfg = tarchs.smoke_config(arch)
    rng = _rng(seed)
    s_text = SEQ - (cfg.n_patches if cfg.family == "vlm" else 0)
    tok = rng.integers(0, cfg.vocab_size, (BATCH, s_text)).astype(np.int32)
    labels = tok.copy()
    labels[0, 5] = -100
    out = {"tokens": tok, "labels": labels}
    if cfg.family == "vlm":
        out["patches"] = rng.normal(
            size=(BATCH, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["enc_frames"] = rng.normal(
            size=(BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


_JAX: dict = {}


def _jax(arch):
    """The JAX model, its parameters (flat numpy), its loss, aux and
    gradients (flat numpy) on ``_batch(arch)``."""
    if arch not in _JAX:
        model = JaxLM(jarchs.smoke_config(arch))
        params = model.init(jax.random.PRNGKey(0))
        batch = {k: jnp.asarray(v) for k, v in _batch(arch).items()}
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            model.loss, has_aux=True))(params, batch)
        flat = {k: np.asarray(v)
                for k, v in _flatten_with_paths(params).items()}
        gflat = {k: np.asarray(v)
                 for k, v in _flatten_with_paths(grads).items()}
        _JAX[arch] = dict(model=model, params=params, flat=flat,
                          loss=float(loss),
                          aux={k: float(v) for k, v in aux.items()},
                          grads=grads, gflat=gflat)
    return _JAX[arch]


def _port(arch, remat=True):
    cfg = tarchs.smoke_config(arch)
    model = LM(cfg, device="cpu", remat=remat)
    model.load_state_dict(lm_params_from_numpy(_jax(arch)["flat"], cfg),
                          strict=True)
    return model


def _tbatch(arch, seed=0):
    return {k: torch.from_numpy(v) for k, v in _batch(arch, seed).items()}


# ---------------------------------------------------------------------------
# (i) the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    ref = _jax(arch)
    model = _port(arch, remat)
    loss, aux, grads = lmtrain.loss_and_grads(model, _tbatch(arch))
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=LOSS_RTOL)
    for key in ("ce", "lb_loss", "router_entropy"):
        np.testing.assert_allclose(float(aux[key]), ref["aux"][key],
                                   rtol=LOSS_RTOL, atol=1e-7)
    got = lm_params_to_numpy(grads, model.cfg)
    assert sorted(got) == sorted(ref["gflat"])
    for key, want in ref["gflat"].items():
        np.testing.assert_allclose(got[key], want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=key)
    assert any(np.abs(g).max() > 0 for g in got.values())


def test_remat_runs_each_ssd_layer_again():
    # the checkpointed layers run their forward again in the backward:
    # on CPU tensors the plain intra-chunk step is called twice a layer
    calls = []
    orig = ssd_ops.ssd_intra_chunk_ref

    def counting(*a):
        calls.append(1)
        return orig(*a)
    for remat, want in ((False, 1), (True, 2)):
        calls.clear()
        ssd_ops.ssd_intra_chunk_ref = counting
        try:
            model = _port("mamba2-130m", remat)
            lmtrain.loss_and_grads(model, _tbatch("mamba2-130m"))
        finally:
            ssd_ops.ssd_intra_chunk_ref = orig
        assert len(calls) == want * model.cfg.n_layers


def test_forward_keeps_no_graph():
    model = _port("mamba2-130m")
    model.requires_grad_(True)
    logits = model(_tbatch("mamba2-130m")["tokens"])
    assert not logits.requires_grad and logits.grad_fn is None


# ---------------------------------------------------------------------------
# (ii) Adam and one step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b",
                                  "deepseek-v2-236b", "whisper-small"])
def test_adam_update_matches_jax(arch):
    ref = _jax(arch)
    jopt, topt = jadam.Adam(lr=1e-3), tadam.Adam(lr=1e-3)
    want, _ = jopt.update(ref["params"], ref["grads"],
                          jopt.init(ref["params"]))
    want = {k: np.asarray(v) for k, v in _flatten_with_paths(want).items()}
    model = _port(arch)
    params = dict(model.named_parameters())
    grads = {k: v.clone() for k, v in lm_params_from_numpy(
        ref["gflat"], model.cfg).items()}
    topt.update(params, grads, topt.init(params))
    got = lm_params_to_numpy(params, model.cfg)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=ADAM_RTOL, atol=1e-7,
                                   err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_lowers_the_loss(arch):
    model = _port(arch)
    opt = tadam.Adam(lr=1e-3)
    state = opt.init(dict(model.named_parameters()))
    batch = _tbatch(arch)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state, diag = lmtrain.train_step(model, opt, state, batch)
    assert np.isfinite(float(diag["loss"])) and float(diag["grad_norm"]) > 0
    assert int(state["step"]) == 1
    moved = sum(float((p.detach() - before[k]).abs().sum())
                for k, p in model.named_parameters())
    assert moved > 0
    with torch.no_grad():
        after, _ = model.loss(**batch)
    assert float(after) < float(diag["loss"])


# ---------------------------------------------------------------------------
# (iii) the SSD path's gradients
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, b, s, h, p, g, n, big=False):
    rng = _rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    # dt * A < 0; "big": a chunk's |dA| sum far above 88
    da = -(rng.uniform(size=(b, s, h)) * (3.0 if big else 0.2)
           ).astype(np.float32)
    bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    cm_ = rng.normal(size=(b, s, g, n)).astype(np.float32)
    init = rng.normal(size=(b, h, p, n)).astype(np.float32)
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dfin = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return (x, da, bm, cm_, init), (dy, dfin)


def _torch_grads(fn, ins, cots, chunk):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y, fin = fn(*ts[:4], chunk, initial_state=ts[4])
    g = torch.autograd.grad((y, fin), ts,
                            [torch.from_numpy(c) for c in cots])
    return [t.numpy() for t in g]


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("dims", [(2, 64, 4, 8, 2, 16), (1, 48, 3, 5, 1, 7)])
def test_ssd_chunked_kernel_grads_match_plain_scan(dims, big):
    b, s, h, p, g, n = dims
    ins, cots = _ssd_inputs(3, b, s, h, p, g, n, big)
    got = _torch_grads(ssd_ops.ssd_chunked_kernel, ins, cots, 16)
    want = _torch_grads(tssm.ssd_chunked, ins, cots, 16)
    for gg, w in zip(got, want):
        assert np.isfinite(gg).all()
        np.testing.assert_allclose(gg, w, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if big:
        return
    # against JAX's gradient of its plain scan
    jx = [jnp.asarray(a) for a in ins]

    def f(x, da, bm, cm_, init):
        return jssm.ssd_chunked(x, da, bm, cm_, 16, initial_state=init)
    _, vjp = jax.vjp(f, *jx)
    jg = vjp(tuple(jnp.asarray(c) for c in cots))
    for gg, w in zip(got, jg):
        np.testing.assert_allclose(gg, np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_large_decay_chunk_gives_finite_gradients():
    # chunks whose |dA| sums pass 88: exp above the diagonal would
    # overflow; the mask comes first, so every gradient is finite
    ins, cots = _ssd_inputs(5, 1, 16, 2, 4, 1, 8, big=True)
    x, da, bm, cm_, _ = (torch.from_numpy(a) for a in ins)
    da_cs = torch.cumsum(da, 1) * 8
    assert float((-da_cs[0, -1]).min()) > 88
    dy = torch.from_numpy(cots[0]).reshape(x.shape)
    dst = torch.from_numpy(_rng(6).normal(size=(1, 2, 4, 8)).astype(
        np.float32))
    grads = ssd_ops.ssd_intra_chunk_bwd(x, da_cs, bm, cm_, dy, dst)
    assert all(torch.isfinite(t).all() for t in grads)
    assert float(grads[1].abs().max()) > 0


def test_backward_wrappers_on_cpu_match_autograd():
    rng = _rng(9)
    bc, l, h, p, g, n = 3, 16, 4, 8, 2, 16
    x, dy = (torch.from_numpy(rng.normal(size=(bc, l, h, p)).astype(
        np.float32)) for _ in range(2))
    da_cs = torch.cumsum(-torch.from_numpy(rng.uniform(
        size=(bc, l, h)).astype(np.float32)), 1)
    bm, cm_ = (torch.from_numpy(rng.normal(size=(bc, l, g, n)).astype(
        np.float32)) for _ in range(2))
    dst = torch.from_numpy(rng.normal(size=(bc, h, p, n)).astype(np.float32))
    ins = [t.clone().requires_grad_(True) for t in (x, da_cs, bm, cm_)]
    y, st = ssd_ref.ssd_intra_chunk_ref(*ins)
    want = torch.autograd.grad((y, st), ins, (dy, dst))
    got = ssd_ops.ssd_intra_chunk_bwd(x, da_cs, bm, cm_, dy, dst)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    # the recurrence's closed-form reverse scan against autograd, 1e-6
    b, nc = 2, 5
    states = torch.from_numpy(rng.normal(size=(b, nc, h, p, n)).astype(
        np.float32)).requires_grad_(True)
    decay = torch.from_numpy(rng.uniform(size=(b, nc, h)).astype(
        np.float32)).requires_grad_(True)
    init = torch.from_numpy(rng.normal(size=(b, h, p, n)).astype(
        np.float32)).requires_grad_(True)
    prev, fin = ssd_ref.chunk_recurrence_ref(states, decay, init)
    dprev, dfin = torch.randn_like(prev), torch.randn_like(fin)
    want = torch.autograd.grad((prev, fin), (states, decay, init),
                               (dprev, dfin))
    got = ssd_ops.chunk_recurrence_bwd(dprev, dfin, prev.detach(),
                                       decay.detach())
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)
    assert ssd_ops.bwd_launches == ssd_ops.state_bwd_launches == 0


def test_backward_wrappers_refuse_mismatched_shapes():
    x = torch.zeros(2, 8, 2, 4)
    da = torch.zeros(2, 8, 2)
    bm = torch.zeros(2, 8, 1, 4)
    with pytest.raises(ValueError, match="dstates"):
        ssd_ops.ssd_intra_chunk_bwd(x, da, bm, bm, x, torch.zeros(2, 2, 4, 5))
    with pytest.raises(ValueError, match="dprev"):
        ssd_ops.chunk_recurrence_bwd(torch.zeros(1, 3, 2, 4, 4),
                                     torch.zeros(1, 2, 4, 4),
                                     torch.zeros(1, 2, 2, 4, 4),
                                     torch.zeros(1, 2, 2))


# ---------------------------------------------------------------------------
# (iv) the cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ignored", ["none", "some", "all"])
def test_cross_entropy_matches_jax(ignored):
    rng = _rng(11)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    if ignored == "some":
        labels[rng.uniform(size=labels.shape) < 0.4] = -100
    elif ignored == "all":
        labels[:] = -100
    want = float(jcm.cross_entropy_loss(jnp.asarray(logits),
                                        jnp.asarray(labels)))
    got = float(tcm.cross_entropy_loss(torch.from_numpy(logits),
                                       torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the gradient too
    lt = torch.from_numpy(logits).requires_grad_(True)
    tcm.cross_entropy_loss(lt, torch.from_numpy(labels)).backward()
    jg = jax.grad(lambda z: jcm.cross_entropy_loss(
        z, jnp.asarray(labels)))(jnp.asarray(logits))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# (v) the smoke test and the dry run's train cases
# ---------------------------------------------------------------------------

def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS=str(TORCH_THREADS))


def test_smoketest_passes():
    proc = subprocess.run([sys.executable, "-m",
                           "repro_torch.launch.smoketest"],
                          capture_output=True, text=True, env=_env(),
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "SMOKE DRYRUN PASSED"
    for arch in ARCHS:
        assert any(ln.startswith(f"{arch}: compile ok, bottleneck=")
                   for ln in lines), arch
    # the reference's batch: 8 sequences of 64 tokens
    from repro_torch.launch import smoketest
    assert dataclasses.asdict(smoketest.SHAPE) == {
        "name": "smoke_train", "seq_len": 64, "global_batch": 8,
        "mode": "train"}


@pytest.fixture
def world():
    """No default process group before or after: a dry run makes its own
    fake world."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_mamba2_train_dry_run_counts_the_ssd_backward(world):
    # rank 0 of 16 x 16: 256 x 4096 over 16 data ranks, 16 sequences of
    # 32 chunks; remat runs each forward kernel twice a layer, each
    # backward once
    rec = dryrun.run_case("mamba2-130m", "train_4k", False)
    k = rec["kernels"]
    bc = 16 * 4096 // 128
    assert k["ssd_intra_chunk"]["calls"] == 48
    assert k["ssd_chunk_recurrence"]["calls"] == 48
    assert k["ssd_intra_chunk_bwd"]["calls"] == 24
    assert k["ssd_chunk_recurrence_bwd"]["calls"] == 24
    assert k["ssd_intra_chunk_bwd"]["flops"] == 24 * ssd_ops.bwd_work(
        (bc, 128, 24, 64), 1, 128)["flops"]
    assert k["ssd_chunk_recurrence_bwd"]["bytes"] == 24 * (
        ssd_ops.state_bwd_work((16, 32, 24, 64, 128))["bytes"])
    # the gradients' all-reduce over the 16 data ranks: every parameter,
    # plus the loss and its three terms
    want = (rec["params"] + 4) * 4
    assert rec["coll_breakdown"] == {"all_reduce": want}
    # Adam's two fp32 moments and its int32 step are live at the peak
    assert rec["memory_analysis"]["optimizer"] == 8 * rec["params"] + 4
    assert rec["model_flops"] == 6.0 * rec["active_params"] * 256 * 4096


@pytest.mark.parametrize("dispatch", ["dense", "scatter"])
def test_moe_train_dry_run(world, dispatch, monkeypatch):
    # llama4 at full width: the scatter dispatch adds its aux all-reduce
    # (2 E + 1 floats a MoE layer, run again by remat) to the gradients'
    monkeypatch.setattr(tattn, "TILE_SCORE_BYTES", 1 << 50)
    arch = "llama4-maverick-400b-a17b"
    rec = dryrun.run_case(arch, "train_4k", False, moe_dispatch=dispatch)
    cfg = tarchs.get_arch(arch)
    assert rec["moe_dispatch"] == dispatch and rec["kernels"] == {}
    grads = (rec["params"] + 4) * 4
    n_moe = (cfg.n_layers - cfg.n_dense_layers) // cfg.moe_every
    aux = 2 * n_moe * (2 * cfg.moe.n_experts + 1) * 4
    assert rec["coll_breakdown"]["all_reduce"] == grads + (
        aux if dispatch == "scatter" else 0)
    assert rec["aten_flops"] > 0 and rec["peak_memory_per_device"] > 0


# ---------------------------------------------------------------------------
# (vi) no JAX
# ---------------------------------------------------------------------------

def test_new_modules_import_no_jax():
    code = ("import sys, repro_torch.train.lm, repro_torch.launch.smoketest, "
            "repro_torch.launch.dryrun, repro_torch.kernels.ssd.ops; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
