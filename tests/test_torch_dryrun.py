"""The port's dry run and H100 roofline (``repro_torch.launch.{dryrun,
roofline,counting}``, ``repro_torch.kernels.tally``) against the JAX
package's conventions and against real CPU runs of the same steps.

Small and CPU-only: ``fcn3_smoke`` / ``fcn3_small`` and ``mamba2-130m``
(its full widths cost nothing on fake tensors).  Every fake world is torn
down where it is made (``dryrun.fake_world``), and the ``world`` fixture
first removes a default group another file may have left in this worker.
The JAX package's ``launch/dryrun.py`` and ``launch/smoketest.py`` are
never imported: they set ``XLA_FLAGS`` and ``REPRO_DFT_MODE`` for the
whole process.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types
import weakref
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _torch_threads import TORCH_THREADS, few_torch_threads  # noqa: F401

import _torch_dist_workers as workers
from repro.configs import archs as jarchs
from repro.configs import fcn3 as jfcn3cfg
from repro.configs import shapes as jshapes
from repro.core.fcn3 import FCN3 as JaxFCN3
from repro.launch import roofline as jroof
from repro.models.transformer import LM as JaxLM
from repro_torch.configs import archs as tarchs
from repro_torch.configs import fcn3 as tfcn3cfg
from repro_torch.configs import shapes as tshapes
from repro_torch.core import fcn3 as tfcn3
from repro_torch.core.sphere import disco as tdisco
from repro_torch.distributed.world import run_world
from repro_torch.inference.engine import GeneratorNoise
from repro_torch.kernels import tally
from repro_torch.kernels.crps import ops as crps_ops
from repro_torch.kernels.disco import ops as disco_ops
from repro_torch.kernels.legendre import ops as legendre_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import counting, dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import roofline
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.train import trainer as ttr

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mamba2-130m"
#: fcn3_full's parameters (the JAX count, PERF.md §4)
FCN3_FULL_PARAMS = 665_667_495


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


def _jax_count(tree) -> float:
    return float(sum(np.prod(leaf.shape)
                     for leaf in jax.tree_util.tree_leaves(tree)))


def _jax_active(cfg, params) -> float:
    """The JAX dry run's ``active_param_count`` (its module sets
    ``XLA_FLAGS`` on import: the formula is restated here)."""
    total = _jax_count(params) - cfg.vocab_size * cfg.d_model * 2
    if cfg.moe:
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        expert = 0.0
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            if any(n in str(path[-1]) for n in ("w_gate", "w_up", "w_down")
                   ) and leaf.ndim >= 3 and e in leaf.shape:
                expert += float(np.prod(leaf.shape))
        total -= expert * (1.0 - k / e)
    return total


# ---------------------------------------------------------------------------
# (a) input_specs
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape),
                     str(tree.dtype).replace("torch.", ""))}


def _jax_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_jax_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype))}


def _specs_pairs():
    pairs = [(arch, shape, False) for arch in sorted(tarchs.ARCHS)
             for shape in ("train_4k", "prefill_32k")]
    pairs += [(ARCH, shape, smoke) for shape in tshapes.INPUT_SHAPES
              for smoke in (False, True)]
    # the attention and MoE families' caches, a ring buffer of 8192 at
    # long_500k
    pairs += [(arch, shape, smoke) for arch in sorted(tarchs.ARCHS)
              if tarchs.ARCHS[arch].family != "ssm"
              for shape in ("decode_32k", "long_500k")
              for smoke in (False, True)]
    return pairs


@pytest.mark.parametrize("arch,shape,smoke", _specs_pairs())
def test_input_specs_match_jax(arch, shape, smoke):
    jcfg = (jarchs.smoke_config(arch) if smoke else jarchs.get_arch(arch))
    tcfg = (tarchs.smoke_config(arch) if smoke else tarchs.get_arch(arch))
    jsh, tsh = jshapes.INPUT_SHAPES[shape], tshapes.INPUT_SHAPES[shape]
    want = jshapes.input_specs(jshapes.adapt_arch_for_shape(jcfg, jsh), jsh)
    got = tshapes.input_specs(tshapes.adapt_arch_for_shape(tcfg, tsh), tsh)
    assert _leaves(got) == _jax_leaves(want)
    assert all(t.device.type == "meta"
               for t in jax.tree_util.tree_leaves(got))


# ---------------------------------------------------------------------------
# (b) parameter counts, (c) model FLOPs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_small_params():
    return jax.eval_shape(JaxFCN3(jfcn3cfg.fcn3_small()).init,
                          jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jax_lm_params():
    return jax.eval_shape(JaxLM(jarchs.get_arch(ARCH)).init,
                          jax.random.PRNGKey(0))


def _fcn3_case(shape, cfg=None, sizes=None):
    with counting.DryRun("cpu") as dry:
        return dryrun.build_fcn3_case(
            shape, None, dry, cfg=cfg or tfcn3cfg.fcn3_small(), sizes=sizes)


def _lm_case(shape):
    with counting.DryRun("cpu") as dry:
        return dryrun.build_lm_case(ARCH, shape, None, dry)


def test_fcn3_small_parameter_count_matches_jax(jax_small_params):
    case = _fcn3_case("inference")
    assert tally.is_fake(case.args[1])       # the members' fake states
    assert case.info["params"] == _jax_count(jax_small_params)


def test_fcn3_full_parameter_count(monkeypatch):
    # the count needs the modules, not the geometry plans
    cfg = tfcn3cfg.fcn3_full()
    nb = len(tfcn3.discolib.morlet_basis_spec(cfg.filter_ell_max,
                                              cfg.filter_m_max))
    monkeypatch.setattr(tfcn3.discolib, "make_disco_plan",
                        lambda *a: types.SimpleNamespace(n_basis=nb,
                                                         stride=2))
    with counting.DryRun("cpu"):
        model = tfcn3.FCN3(cfg, device="cpu")
        assert tally.is_fake(model.enc_atmos.weight)
        n = dryrun._count(dict(model.named_parameters()))
    assert n == FCN3_FULL_PARAMS


def test_lm_active_parameter_count_matches_jax(jax_lm_params):
    case = _lm_case("prefill_32k")
    cfg = jarchs.get_arch(ARCH)
    assert case.info["params"] == _jax_count(jax_lm_params)
    assert case.info["active_params"] == _jax_active(cfg, jax_lm_params)


@pytest.mark.parametrize("shape", sorted(dryrun.FCN3_SHAPES))
def test_fcn3_model_flops_follow_the_jax_convention(shape, jax_small_params):
    case = _fcn3_case(shape)
    sh = dryrun.FCN3_SHAPES[shape]
    cfg = jfcn3cfg.fcn3_small()
    pixels = cfg.latent_nlat * cfg.latent_nlon
    mf = (6.0 * _jax_count(jax_small_params) * 0.05 * pixels * sh["batch"]
          * sh["ensemble"] * sh["rollout"])
    if sh["mode"] == "infer":
        mf = mf / 6.0 * 2.0
    assert case.model_flops == pytest.approx(mf, rel=1e-12)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_lm_model_flops_follow_the_jax_convention(shape, jax_lm_params):
    case = _lm_case(shape)
    sh = jshapes.INPUT_SHAPES[shape]
    n = _jax_active(jarchs.get_arch(ARCH), jax_lm_params)
    tokens = sh.global_batch * (sh.seq_len if sh.mode == "prefill" else 1)
    assert case.model_flops == pytest.approx(
        jroof.model_flops_decode(n, tokens), rel=1e-12)
    assert roofline.model_flops_train(n, 7.0) == jroof.model_flops_train(
        n, 7.0)


# ---------------------------------------------------------------------------
# (d) the roofline's arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flops,nbytes,coll", [
    (3.3e15, 1.0e12, 2.0e9),     # compute-bound
    (1.0e12, 4.0e12, 1.0e9),     # memory-bound
    (1.0e12, 1.0e11, 9.0e11),    # collective-bound
])
def test_roofline_terms_match_jax_on_the_h100_constants(monkeypatch, flops,
                                                         nbytes, coll):
    monkeypatch.setattr(jroof, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jroof, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jroof, "ICI_BW", roofline.ICI_BW)
    kw = dict(name="case", chips=256, flops_per_device=flops,
              hbm_bytes_per_device=nbytes, collective_bytes_per_device=coll,
              coll_breakdown={"all_to_all": int(coll)},
              peak_memory_per_device=1e9, model_flops=0.3 * flops * 256)
    want = jroof.Roofline(**kw)
    got = roofline.Roofline(**kw, coll_nvlink_bytes=coll)
    for term in ("t_compute", "t_memory", "t_collective", "step_time_bound",
                 "mfu_bound", "useful_flop_ratio"):
        assert getattr(got, term) == pytest.approx(getattr(want, term),
                                                   rel=1e-12), term
    assert got.bottleneck == want.bottleneck
    assert got.t_compute_fp32 == flops / roofline.PEAK_FP32_FLOPS
    d = got.to_dict()
    assert set(want.to_dict()) <= set(d)
    # across nodes a collective takes the node-to-node rate
    ib = roofline.Roofline(**kw, coll_ib_bytes=coll)
    assert ib.t_collective == coll / roofline.IB_BW


def test_h100_model_constants():
    assert roofline.PEAK_FLOPS == 495e12 / 3
    assert (roofline.PEAK_FP32_FLOPS, roofline.HBM_BW) == (67e12, 3.35e12)
    assert (roofline.NVLINK_BW, roofline.IB_BW) == (450e9, 50e9)
    assert tally.NODE_GPUS == 8


# ---------------------------------------------------------------------------
# the kernels' counts: one formula, shared with chip_smoke.py
# ---------------------------------------------------------------------------

def test_kernel_formulas_at_phase7_rows():
    # PERF.md §6's rows, to their three figures (half a unit: 5e-3)
    # Legendre forward, the latent SHT slab: 1354 complex rows, 360^3
    leg = legendre_ops.work((1354, 360, 360), 360, True, 1, 4 * 360)
    assert leg["bytes"] == pytest.approx(2.99e9, rel=5e-3)
    assert leg["flops"] == 2 * 2 * 1354       # per non-zero of the table
    assert leg["flops_dense"] == pytest.approx(2.53e11, rel=5e-3)
    # the latent band: 295 planes of 360 x 720, psi 7 x 360 x 7 x 209
    band = disco_ops.work((295, 360, 720), (7, 360, 7, 209), 1, 1)
    assert band["bytes"] == pytest.approx(2.46e9, rel=5e-3)
    assert band["flops"] == 2 * 720 * 295
    assert band["flops_dense"] == pytest.approx(1.57e12, rel=5e-3)
    crps = crps_ops.work(2, 74_753_280)
    assert (crps["flops"], crps["bytes"]) == (pytest.approx(9.72e8, rel=5e-3),
                                              pytest.approx(1.20e9, rel=5e-3))
    bwd = crps_ops.work(2, 74_753_280, backward=True)
    assert (bwd["flops"], bwd["bytes"]) == (pytest.approx(1.79e9, rel=5e-3),
                                            pytest.approx(1.79e9, rel=5e-3))
    ssd = ssd_ops.work((512, 128, 24, 64), 1, 128)
    assert (ssd["flops"], ssd["bytes"]) == (pytest.approx(3.98e10, rel=5e-3),
                                            pytest.approx(1.28e9, rel=5e-3))
    st = ssd_ops.state_work((2, 256, 24, 64, 128))
    assert (st["flops"], st["bytes"]) == (pytest.approx(2.01e8, rel=5e-3),
                                          pytest.approx(8.09e8, rel=5e-3))


def test_a_tables_count_is_carried_to_its_transposed_view():
    t = torch.zeros((4, 5, 6))
    t[1, 2, 3] = t[0, 0, 0] = 1.0
    with counting.DryRun("cpu") as dry:
        f = dry.fake({"t": t})["t"]
        assert tally.nnz(f) == 2 and tally.nnz(f.permute(1, 0, 2)) == 2
        with pytest.raises(ValueError, match="non-zeros"):
            tally.nnz(torch.empty((3, 3)))
    assert tally.nnz(t.transpose(0, 1)) == 2


# ---------------------------------------------------------------------------
# (e) agreement with real runs, (f) no side effects
# ---------------------------------------------------------------------------

def _recording(monkeypatch):
    """Wrap the kernel wrappers to note each call's (family, key)."""
    seen: dict = {}

    def note(key):
        seen[key] = seen.get(key, 0) + 1

    orig = {"leg": legendre_ops.legendre_contract,
            "band": disco_ops.disco_band_contract,
            "tr": disco_ops.disco_band_transpose,
            "crps": crps_ops.crps_fused, "bwd": crps_ops.crps_fused_bwd}

    def leg(x, table, extents, blocks=None):
        note(("legendre_contract", legendre_ops.call_key(x, table)))
        return orig["leg"](x, table, extents, blocks)

    def band(x, psi, lat, taps, stride=1, blocks=None):
        note(("disco_band_contract", (tuple(x.shape), tuple(psi.shape),
                                      stride)))
        return orig["band"](x, psi, lat, taps, stride, blocks)

    def tr(g, psi, lat, taps, rows, h_in, stride=1, blocks=None):
        note(("disco_band_transpose", (tuple(g.shape), tuple(psi.shape),
                                       h_in, stride)))
        return orig["tr"](g, psi, lat, taps, rows, h_in, stride, blocks)

    def crps(ens, obs, fair=False, blocks=None):
        note(("crps_fused", (tuple(ens.shape), fair)))
        return orig["crps"](ens, obs, fair, blocks)

    def bwd(g, ens, obs, fair=False, blocks=None):
        note(("crps_fused_bwd", (tuple(ens.shape), fair)))
        return orig["bwd"](g, ens, obs, fair, blocks)

    monkeypatch.setattr(legendre_ops, "legendre_contract", leg)
    monkeypatch.setattr(disco_ops, "disco_band_contract", band)
    monkeypatch.setattr(disco_ops, "disco_band_transpose", tr)
    monkeypatch.setattr(crps_ops, "crps_fused", crps)
    monkeypatch.setattr(crps_ops, "crps_fused_bwd", bwd)
    return seen


def _dry_calls(shape, cfg, sizes):
    with counting.DryRun("cpu") as dry:
        case = dryrun.build_fcn3_case(shape, None, dry, cfg=cfg, sizes=sizes)
        _, counts = roofline.analyze("x", case.step, case.args, 1,
                                     case.model_flops, dry)
    return {k: v[0] for k, v in counts.kernel_calls.items()}, counts


def test_kernel_calls_of_a_train_step_match_a_real_run(monkeypatch):
    cfg = tfcn3cfg.fcn3_smoke()
    want_calls, counts = _dry_calls("train", cfg, (1, 2, 1))
    model = tfcn3.FCN3(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    tr = ttr.EnsembleTrainer(model, ttr.TrainConfig(ensemble_size=2),
                             tfcn3cfg.channel_weights(cfg.n_levels))
    bufs = dict(model.make_buffers(), **tr.make_loss_buffers())
    g = torch.Generator().manual_seed(1)
    hw = (cfg.nlat, cfg.nlon)
    batch = {"state": torch.randn((1, cfg.n_state) + hw, generator=g),
             "targets": torch.randn((1, 1, cfg.n_state) + hw, generator=g),
             "aux": torch.randn((1, 1, cfg.n_aux) + hw, generator=g)}
    opt = tr.optimizer.init(dict(model.named_parameters()))
    seen = _recording(monkeypatch)
    tr.train_step(bufs, opt, batch, GeneratorNoise(torch.Generator()))
    assert seen == want_calls
    assert {f for f, _ in seen} == {"legendre_contract", "disco_band_contract",
                                    "disco_band_transpose", "crps_fused",
                                    "crps_fused_bwd"}
    # the count splits into kernels and aten, and the kernels' FLOPs are
    # the tables' non-zeros at every call
    assert counts.kernel_flops > 0 and counts.aten_flops > 0
    assert counts.aten_bytes > 0 and counts.peak_bytes > 0
    assert {"parameters", "optimizer", "buffers", "inputs"} <= set(
        counts.at_peak)


def test_kernel_calls_of_a_forward_match_a_real_run(monkeypatch):
    cfg = tfcn3cfg.fcn3_smoke()
    want_calls, _ = _dry_calls("inference", cfg, (1, 2, 1))
    model = tfcn3.FCN3(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    bufs = model.make_buffers()
    g = torch.Generator().manual_seed(2)
    hw = (cfg.nlat, cfg.nlon)
    seen = _recording(monkeypatch)
    with torch.no_grad():
        model(bufs, torch.randn((2, 1, cfg.n_state) + hw, generator=g),
              torch.randn((2, 1, cfg.n_cond_in) + hw, generator=g))
    assert seen == want_calls


class _RealCounter(counting.Counter):
    """The dry run's counter following real CPU tensors: a real step's
    live set, by the same bookkeeping."""

    def track(self, t):
        if not isinstance(t, torch.Tensor):
            return None
        st = t.untyped_storage()
        rec = self._stores.get(st)
        if rec is None:
            self.seq += 1
            rec = counting._Storage(st.nbytes(), self.seq)
            self._stores[st] = rec
            self.records.append(rec)
            weakref.finalize(st, self._free, rec)
            self.live += rec.nbytes
            if self.live > self.peak:
                self.peak, self.peak_seq = self.live, self.seq
        return rec

    def _fake(self, a):
        return a


def test_the_live_set_peak_is_a_real_steps(monkeypatch):
    # fcn3_small with the DISCO merge in 4 MB checkpointed chunks puts the
    # peak in the backward, where some fake storages outlive their use
    # until a garbage collection (twice the peak with the collector off)
    monkeypatch.setattr(tdisco.DiscoConv.forward, "__defaults__",
                        (4 << 20, None))
    cfg = tfcn3cfg.fcn3_small()
    with counting.DryRun("cpu") as dry:
        case = dryrun.build_fcn3_case("train", None, dry, cfg=cfg,
                                      sizes=(1, 2, 1))
        _, fake = roofline.analyze("x", case.step, case.args, 1,
                                   case.model_flops, dry)
    # the same step on real tensors, every kernel call answered by its
    # counting branch (an empty output: what a kernel allocates)
    monkeypatch.setattr(tally, "is_fake", lambda *ts: True)
    monkeypatch.setattr(tally, "nnz", lambda t: 1)
    real = _RealCounter(None, "cpu")
    with real:
        model = tfcn3.FCN3(cfg, device="cpu")
        params = dict(model.named_parameters())
        tr = ttr.EnsembleTrainer(model, ttr.TrainConfig(ensemble_size=2),
                                 tfcn3cfg.channel_weights(cfg.n_levels))
        bufs = dict(model.make_buffers(), **tr.make_loss_buffers())
        hw = (cfg.nlat, cfg.nlon)
        batch = {"state": torch.empty((1, cfg.n_state) + hw),
                 "targets": torch.empty((1, 1, cfg.n_state) + hw),
                 "aux": torch.empty((1, 1, cfg.n_aux) + hw)}
        opt = tr.optimizer.init(params)
        real.label((params, bufs, batch, opt), "held")
        real.reset_peak()
        real.counting = True
        loss, aux, grads = tr.loss_and_grads(bufs, batch,
                                             GeneratorNoise(torch.Generator()))
        tr.optimizer.update(params, grads, opt)
    assert fake.peak_bytes == real.peak
    assert fake.at_peak["activations"] > 0.5 * fake.peak_bytes


def test_domain_collective_bytes_match_a_gloo_world(world):
    sizes = (1, 2, 1)
    res = run_world(workers.domain_kinds_rank, 2, (sizes,), timeout=300.0,
                    threads=TORCH_THREADS)
    assert not any(r["jax_loaded"] for r in res)
    with dryrun.fake_world(2):
        mesh = meshlib.make_mesh((1, 2), ("data", "model"), "cpu")
        with counting.DryRun("cpu") as dry:
            case = dryrun.build_fcn3_case(
                "train", mesh, dry, cfg=tfcn3cfg.fcn3_smoke(), sizes=sizes)
            assert case.info["io_rows"] == res[0]["rows"]
            _, counts = roofline.analyze("x", case.step, case.args, 2,
                                         case.model_flops, dry)
    got = counts.collective_bytes()
    want = res[0]["kinds"]
    assert got["all_to_all_v"] == want["all_to_all_v"] > 0
    assert got["all_to_all"] == want["all_to_all"] > 0
    assert got.get("all_reduce", 0) == want["all_reduce"]


def test_a_dry_run_launches_nothing_and_runs_no_plain_version(monkeypatch):
    calls = []
    for mod, names in ((legendre_ops, ("legendre_contract_ref",)),
                       (disco_ops, ("disco_gather_band_contract_ref",
                                    "disco_band_transpose_ref")),
                       (crps_ops, ("crps_fused_ref", "crps_fused_bwd_ref")),
                       (ssd_ops, ("ssd_intra_chunk_ref",
                                  "chunk_recurrence_ref"))):
        for name in names:
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=fn, **k: (
                calls.append(_n), _f(*a, **k))[1])
    for mod in (legendre_ops, disco_ops, crps_ops, ssd_ops):
        mod.reset_launches()
    seen, _ = _dry_calls("train", tfcn3cfg.fcn3_smoke(), (1, 2, 1))
    cfg = dataclasses.replace(tarchs.smoke_config(ARCH))
    with counting.DryRun("cpu") as dry:
        case = dryrun.build_lm_case(ARCH, "prefill_32k", None, dry, cfg=cfg)
        _, lm = roofline.analyze("x", case.step, case.args, 1,
                                 case.model_flops, dry)
    assert seen and lm.kernels["ssd_intra_chunk"]["calls"] == cfg.n_layers
    assert lm.kernels["ssd_chunk_recurrence"]["calls"] == cfg.n_layers
    assert calls == []
    assert (legendre_ops.launches, disco_ops.launches,
            disco_ops.transpose_launches, crps_ops.launches,
            crps_ops.bwd_launches, ssd_ops.launches,
            ssd_ops.state_launches) == (0,) * 7


#: the architectures of the dense, hybrid, VLM and audio families
ATTN_ARCHS = sorted(n for n, c in tarchs.ARCHS.items()
                    if c.family not in ("ssm", "moe"))


def _lm_counts(arch, shape, cfg=None):
    with counting.DryRun("cpu") as dry:
        case = dryrun.build_lm_case(arch, shape, None, dry, cfg=cfg)
        rl, counts = roofline.analyze("x", case.step, case.args, 1,
                                      case.model_flops, dry)
    return case, rl, counts


def test_zamba2_prefill_dry_run_counts_one_ssd_call_a_layer(monkeypatch):
    # zamba2-2.7b at full width, prefill_32k (batch 32): both SSD kernels
    # once per Mamba-2 layer at the 80-head shape; one query tile a layer
    # keeps the fake run short (the SSD counts do not depend on it)
    monkeypatch.setattr(tattn, "TILE_SCORE_BYTES", 1 << 50)
    case, _, counts = _lm_counts("zamba2-2.7b", "prefill_32k")
    k = counts.kernels
    assert k["ssd_intra_chunk"]["calls"] == 54
    assert k["ssd_chunk_recurrence"]["calls"] == 54
    bc = 32 * 32768 // 128
    assert k["ssd_intra_chunk"]["flops"] == 54 * ssd_ops.work(
        (bc, 128, 80, 64), 1, 64)["flops"]
    assert case.info["params"] == 2_422_670_240


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k",
                                   "long_500k"])
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_attention_family_dry_runs_at_smoke_widths(arch, shape,
                                                   monkeypatch):
    # every ported family's cases on fake tensors at the shapes' batch and
    # sequence, smoke widths; one query tile a layer
    monkeypatch.setattr(tattn, "TILE_SCORE_BYTES", 1 << 50)
    cfg = tshapes.adapt_arch_for_shape(tarchs.smoke_config(arch),
                                       tshapes.INPUT_SHAPES[shape])
    _, rl, counts = _lm_counts(arch, shape, cfg)
    ssd = counts.kernels.get("ssd_intra_chunk", {}).get("calls", 0)
    want = cfg.n_layers if (cfg.family == "hybrid"
                            and shape == "prefill_32k") else 0
    assert ssd == want
    assert counts.aten_flops > 0 and counts.at_peak["parameters"] > 0
    rec = rl.to_dict()
    assert np.isfinite(rec["t_memory_s"]) and rec["t_memory_s"] > 0


MOE_ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")


@pytest.fixture(scope="module")
def jax_moe_params():
    return {arch: jax.eval_shape(JaxLM(jarchs.get_arch(arch)).init,
                                 jax.random.PRNGKey(0))
            for arch in MOE_ARCHS}


@pytest.mark.parametrize("dispatch", ["dense", "scatter"])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dry_runs_at_full_width(arch, shape, dispatch, world,
                                    jax_moe_params, monkeypatch):
    # rank 0 of the 16 x 16 production mesh; the batch splits over the 16
    # data ranks, so scatter runs over them (one all_reduce of the aux
    # sums, 2 E + 1 floats, a MoE layer) and dense runs on the rank's own
    # slice; either runs rank 0's E/16 experts and all-gathers the (E, C,
    # D) outputs over the 16 model ranks; no kernel of the port is
    # called; one query tile a layer
    monkeypatch.setattr(tattn, "TILE_SCORE_BYTES", 1 << 50)
    rec = dryrun.run_case(arch, shape, False, moe_dispatch=dispatch)
    cfg = jarchs.get_arch(arch)
    params = jax_moe_params[arch]
    assert rec["params"] == _jax_count(params)
    assert rec["active_params"] == _jax_active(cfg, params)
    assert rec["moe_dispatch"] == dispatch and rec["kernels"] == {}
    assert rec["experts_per_rank"] == cfg.moe.n_experts // 16
    n_moe = (cfg.n_layers - cfg.n_dense_layers) // cfg.moe_every
    shape_ = tshapes.INPUT_SHAPES[shape]
    tokens = rec["local_batch"] * (1 if shape_.mode == "decode"
                                   else shape_.seq_len)
    cap = tmoe._capacity(tokens, tarchs.get_arch(arch).moe)
    want = {"all_gather": n_moe * cfg.moe.n_experts * cap * cfg.d_model * 4}
    if dispatch == "scatter":
        want["all_reduce"] = n_moe * (2 * cfg.moe.n_experts + 1) * 4
    assert rec["coll_breakdown"] == want
    assert {c["group"] for c in rec["collectives"]} == {16}
    assert rec["aten_flops"] > 0 and rec["peak_memory_per_device"] > 0


def test_dense_dispatch_costs_more_flops_than_scatter(world, monkeypatch):
    # deepseek-v2's prefill on rank 0's 2 x 32768 tokens: the (T, E, C)
    # one-hot products of the dense dispatch grow with T^2
    monkeypatch.setattr(tattn, "TILE_SCORE_BYTES", 1 << 50)
    flops = {d: dryrun.run_case(MOE_ARCHS[0], "prefill_32k", False,
                                moe_dispatch=d)["aten_flops"]
             for d in ("dense", "scatter")}
    assert flops["dense"] > 2 * flops["scatter"]


def test_a_batch_that_does_not_split_takes_the_dense_path(world):
    # long_500k's batch of 1 over 16 data ranks: whole on every rank
    rec = dryrun.run_case(MOE_ARCHS[1], "long_500k", False,
                          moe_dispatch="scatter")
    assert rec["local_batch"] == 1 and rec["moe_dispatch"] == "dense"
    # no aux all-reduce over the data ranks; the experts' outputs are
    # gathered over the model ranks
    assert set(rec["coll_breakdown"]) == {"all_gather"}


def test_the_16_rank_fcn3_small_layout_gathers_every_halo():
    # 181 IO rows and 90 latent rows over 16 ranks: blocks of 11-12 and
    # 5-6 rows; every rank's halo of each band must come from the ranks
    # that hold its rows (Halo.of refuses blocks that do not cover them)
    from repro_torch.distributed import domain
    cfg = tfcn3cfg.fcn3_small()
    model = tfcn3.FCN3(cfg, device="cpu")
    io = [domain.row_block(cfg.nlat, q, 16) for q in range(16)]
    lat = [domain.row_block(cfg.latent_nlat, q, 16) for q in range(16)]
    for plan, outs, ins in ((model.enc_plan, lat, io),
                            (model.latent_plan, lat, lat),
                            (model.dec_plan, io, io)):
        needs = [domain.halo_rows(plan, *b) for b in outs]
        for r in range(16):
            halo = domain.Halo.of(needs, ins, r)
            assert sum(halo.recv_sizes) + len(halo.own) == len(needs[r])
            assert sum(1 for n in halo.recv_sizes if n) == (
                1 if r in (0, 15) else 2)


# ---------------------------------------------------------------------------
# (g) refusals, (h) the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,mode", [
    ("train", "channel"), ("inference", "channel"),
    ("rollout4", "ensemble")])
def test_refusals_name_their_roadmap_item(world, shape, mode):
    # the cases refused until the channel and member placements ran now
    # return rank 0's record on the 16 x 16 production mesh
    with dryrun.fake_world(256):
        mesh = meshlib.make_mesh((16, 16), ("data", "model"), "cpu")
        with counting.DryRun("cpu") as dry:
            case = dryrun.build_fcn3_case(shape, mesh, dry, fcn3_mode=mode,
                                          cfg=tfcn3cfg.fcn3_smoke())
            rl, counts = roofline.analyze("x", case.step, case.args, 256,
                                          case.model_flops, dry)
    coll = counts.collective_bytes()
    if mode == "channel":
        # smoke's mlp_hidden 32 splits 16 ways, its 34 channels do not
        assert case.info["split_leaves"] == 6
        assert coll["all_reduce"] > 0 and "all_gather" not in coll
    else:
        # 2 members whole on each of 16 model ranks, the batch of 4 whole
        # on each of 16 data ranks (neither divides)
        assert case.info["members_per_rank"] == 2
        assert tally.is_fake(case.args[2]["state"])
        assert case.args[2]["state"].shape[0] == 4
    assert rl.peak_memory_per_device > 0 and counts.kernels


@pytest.mark.parametrize("arch,experts", [("deepseek-v2-236b", 10),
                                          ("llama4-maverick-400b-a17b", 8)])
def test_moe_experts_are_placed_over_the_model_axis(world, arch, experts):
    rec = dryrun.run_case(arch, "decode_32k", False)
    assert rec["experts_per_rank"] == experts
    # the expert outputs gathered over the 16 model ranks, nothing else
    assert set(rec["coll_breakdown"]) == {"all_gather"}
    assert {c["group"] for c in rec["collectives"]} == {16}
    # rank 0's fp32 parameters: most of the stacks' bytes are elsewhere
    assert rec["memory_analysis"]["parameters"] < 4 * rec["params"] / 2


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS=str(TORCH_THREADS))


def test_cli_prints_a_record_and_ok(tmp_path):
    out = tmp_path / "r.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "fcn3",
         "--shape", "train", "--reduced-fcn3", "--out", str(out)],
        capture_output=True, text=True, env=_env(), timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT_JSON:"))
    rec = json.loads(line[len("RESULT_JSON:"):])
    assert "DRYRUN OK: fcn3/train mesh=16x16" in proc.stdout
    assert rec == json.loads(out.read_text())
    assert rec["chips"] == 256 and rec["fcn3_sharding"] == "domain"
    assert rec["coll_breakdown"]["all_to_all_v"] > 0
    assert rec["coll_breakdown"]["all_to_all"] > 0
    assert rec["kernel_flops"] > 0 and rec["aten_flops"] > 0
    assert rec["flops_per_device"] == rec["kernel_flops"] + rec["aten_flops"]
    assert set(rec["kernels"]) == {"legendre_contract", "disco_band_contract",
                                   "disco_band_transpose", "crps_fused",
                                   "crps_fused_bwd"}
    assert rec["peak_memory_per_device"] > 0 and rec["memory_analysis"]
    for key in ("t_compute_s", "t_compute_fp32_s", "t_memory_s",
                "t_collective_s", "mfu_bound", "useful_flop_ratio"):
        assert np.isfinite(rec[key]) and rec[key] > 0, key


def test_new_modules_import_no_jax():
    code = ("import sys, repro_torch.launch.dryrun, "
            "repro_torch.launch.roofline; assert 'jax' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
