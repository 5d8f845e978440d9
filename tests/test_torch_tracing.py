"""The port's spans (``repro_torch.telemetry.span`` / ``setup_span``) on
the CPU: off, a span is one shared no-op object and nothing is recorded;
under ``torch.profiler`` each span is a user-annotation range on the
profiler's clock around the ops launched inside it, recorded into the
bounded process trace under the innermost span open on its thread, never
open across the engine's ``yield``; the smoke engine and trainer emit
exactly the spans PERF.md names, with outputs bitwise those of an
unprofiled run.  Also ``launch/lm.py::report_profile``'s busy time."""

import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_threads import few_torch_threads  # noqa: F401

from repro_torch import telemetry
from repro_torch.configs import fcn3 as cfgs
from repro_torch.core.fcn3 import FCN3
from repro_torch.core.sphere import disco as discolib
from repro_torch.core.sphere import grids as glib
from repro_torch.core.sphere import interp as interplib
from repro_torch.core.sphere import legendre as leg
from repro_torch.inference.engine import (EngineConfig, ForecastEngine,
                                          GeneratorNoise, members_noise)
from repro_torch.kernels import build
from repro_torch.launch import lm
from repro_torch.train.trainer import EnsembleTrainer, TrainConfig

LEADS, CHUNK, MEMBERS = 4, 2, 2


@pytest.fixture
def fresh(monkeypatch):
    """An empty process trace for the test (the module's is restored)."""
    monkeypatch.setattr(telemetry, "_process", None)
    return telemetry


def profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def tree(spans: list[dict]) -> list:
    """``spans`` as nested ``(name, args, children)`` by their parent
    links; the roots are the spans whose parent is not among them."""
    ids = {s["id"] for s in spans}
    kids: dict = {}
    for s in spans:
        kids.setdefault(s["parent"] if s["parent"] in ids else None,
                        []).append(s)

    def node(s):
        return (s["name"], s["args"],
                [node(c) for c in kids.get(s["id"], [])])
    return [node(s) for s in kids.get(None, [])]


# ---------------------------------------------------------------------------
# off


def test_off_span_is_the_shared_no_op_and_records_nothing(fresh):
    assert not torch._C._autograd._profiler_enabled()
    sp = telemetry.span("engine.lead", member_leads=4)
    assert sp is telemetry.NULL_SPAN
    with sp, telemetry.span("fcn3.forward"):
        torch.ones(3).sum()
    assert telemetry._process is None
    assert telemetry.process_spans() == []


def test_telemetry_loads_no_torch():
    code = ("import sys; from repro_torch import telemetry as t; "
            "s = t.span('engine.lead'); "
            "assert s is t.NULL_SPAN, s\n"
            "with t.setup_span('plans.build', kind='k'): pass\n"
            "assert 'torch' not in sys.modules\n"
            "print([x['name'] for x in t.process_spans()])")
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, env={"PYTHONPATH": src})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['plans.build']"


# ---------------------------------------------------------------------------
# on


def test_span_is_a_user_annotation_around_its_ops(fresh):
    with profiled() as prof:
        with telemetry.span("engine.lead", member_leads=2):
            (torch.ones(64) * 2.0).sum()
    events = list(prof.profiler.kineto_results.events())
    (ann,) = [e for e in events if e.name() == "engine.lead"]
    assert ann.is_user_annotation()
    lo, hi = ann.start_ns(), ann.start_ns() + ann.duration_ns()
    ops = [e for e in events
           if e.name() in ("aten::ones", "aten::mul", "aten::sum")]
    assert {e.name() for e in ops} == {"aten::ones", "aten::mul",
                                       "aten::sum"}
    for e in ops:
        assert lo <= e.start_ns() and e.start_ns() + e.duration_ns() <= hi
    (rec,) = telemetry.process_spans()
    assert rec["name"] == "engine.lead"
    assert rec["args"] == {"member_leads": 2}
    assert rec["dur_s"] > 0 and rec["device_ms"] is None   # no CUDA here
    # the profiler's clock is Unix-epoch time, the host's wall clock
    assert abs(lo - time.time_ns()) < 60e9


def test_parents_are_the_spans_open_on_the_same_thread(fresh):
    seen = {}

    def worker():
        # the profiler collects on the thread that started it alone
        seen["hot"] = telemetry.span("engine.stage_wait")
        with telemetry.setup_span("plans.build", kind="disco"):
            seen["worker"] = True

    with profiled():
        with telemetry.span("trainer.step"):
            with telemetry.span("trainer.forward"):
                with telemetry.span("fcn3.forward"):
                    t = threading.Thread(target=worker)
                    t.start()
                    t.join(timeout=30)
            with telemetry.span("trainer.adam"):
                pass
    assert not t.is_alive() and seen["worker"]
    spans = telemetry.process_spans()
    by = {s["name"]: s for s in spans}
    root = telemetry.process_trace().root
    assert by["trainer.step"]["parent"] == root
    assert by["trainer.forward"]["parent"] == by["trainer.step"]["id"]
    assert by["fcn3.forward"]["parent"] == by["trainer.forward"]["id"]
    assert by["trainer.adam"]["parent"] == by["trainer.step"]["id"]
    # another thread's span is not a child of this thread's open spans
    assert seen["hot"] is telemetry.NULL_SPAN
    assert by["plans.build"]["parent"] == root
    assert by["plans.build"]["tid"] != by["trainer.step"]["tid"]


def test_device_ms_comes_from_the_span_events(fresh, monkeypatch):
    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.t = None

        def record(self):
            self.t = time.perf_counter()

        def synchronize(self):
            assert self.t is not None

        def elapsed_time(self, end):
            return 1e3 * (end.t - self.t)

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    with profiled():
        with telemetry.span("trainer.backward"):
            time.sleep(0.01)
    with telemetry.setup_span("kernels.load", name="crps", built=False):
        pass
    back, load = telemetry.process_spans()
    assert back["device_ms"] == pytest.approx(1e3 * back["dur_s"], rel=0.5)
    assert back["device_ms"] >= 10.0
    assert load["device_ms"] is None


def smoke_model(seed: int = 0) -> FCN3:
    model = FCN3(cfgs.fcn3_smoke(), device="cpu")
    model.init(torch.Generator().manual_seed(seed))
    return model


def forecast(scored: bool):
    """A smoke forecast of ``LEADS`` leads in chunks of ``CHUNK``: its
    per-chunk results."""
    model = smoke_model()
    c = model.cfg
    g = torch.Generator().manual_seed(1)
    state0 = torch.randn((c.n_state, c.nlat, c.nlon), generator=g)
    aux = torch.randn((LEADS, c.n_aux, c.nlat, c.nlon), generator=g)
    truth = torch.randn((LEADS, c.n_state, c.nlat, c.nlon), generator=g)
    eng = ForecastEngine(model, EngineConfig(members=MEMBERS,
                                             lead_chunk=CHUNK))
    return list(eng.stream(model.make_buffers(), state0, aux,
                           members_noise(model, 2),
                           truth=truth if scored else None))


def train():
    """One smoke train step: its diagnostics, the updated parameters and
    Adam's moments."""
    model = smoke_model()
    c = model.cfg
    tr = EnsembleTrainer(model, TrainConfig(ensemble_size=2, fair_crps=True),
                         cfgs.channel_weights(c.n_levels))
    buffers = dict(model.make_buffers(), **tr.make_loss_buffers())
    g = torch.Generator().manual_seed(3)
    batch = {"state": torch.randn((1, c.n_state, c.nlat, c.nlon),
                                  generator=g),
             "targets": torch.randn((1, 1, c.n_state, c.nlat, c.nlon),
                                    generator=g),
             "aux": torch.randn((1, 1, c.n_aux, c.nlat, c.nlon),
                                generator=g)}
    opt = tr.optimizer.init(dict(model.named_parameters()))
    opt, aux = tr.train_step(buffers, opt, batch,
                             GeneratorNoise(torch.Generator().manual_seed(4)))
    return {"aux": aux, "params": {k: p.detach() for k, p in
                                   model.named_parameters()},
            "mu": opt["mu"], "nu": opt["nu"]}


RUNS = {"forecast": lambda: forecast(False),
        "forecast_scored": lambda: forecast(True), "train": train}
_cache: dict = {}


def runs(case: str):
    """``case`` run unprofiled and profiled, with the profiled run's
    spans (computed once a module)."""
    if case not in _cache:
        plain = RUNS[case]()
        saved = telemetry._process
        telemetry._process = None
        try:
            with profiled():
                traced = RUNS[case]()
            spans = telemetry.process_spans()
        finally:
            telemetry._process = saved
        _cache[case] = plain, traced, spans
    return _cache[case]


def model_step(kinds=("global", "local")) -> tuple:
    return ("fcn3.forward", {}, [("fcn3.encoder", {}, [])] + [
        (f"fcn3.block.{k}", {"index": i}, []) for i, k in enumerate(kinds)]
        + [("fcn3.decoder", {}, [])])


def expected_tree(case: str) -> list:
    if case == "train":
        return [("trainer.step", {}, [
            ("trainer.forward", {}, [model_step()]),
            ("trainer.backward", {}, []),
            ("trainer.adam", {}, [])])]
    lead = ("engine.lead", {"member_leads": MEMBERS},
            [model_step(), ("engine.scores", {}, [])])
    return [("engine.chunk", {"start": s, "steps": CHUNK, "batch": 1},
             [("engine.stage_wait", {}, [])] + [lead] * CHUNK)
            for s in range(0, LEADS, CHUNK)]


@pytest.mark.parametrize("case", sorted(RUNS))
def test_smoke_path_emits_the_span_tree(case):
    _, _, spans = runs(case)
    # set-up spans of the profiled run's own model (plans it had cached
    # are no miss) are left out: the hot spans' tree is the table's
    hot = [s for s in spans if s["name"] not in ("plans.build",
                                                 "kernels.load")]
    assert tree(hot) == expected_tree(case)
    assert all(s["dur_s"] is not None and s["dur_s"] >= 0 for s in hot)


def flat(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in flat(out[k])]
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in flat(v)]
    if hasattr(out, "scores"):
        return flat([out.scores, out.final_state, out.final_noise])
    return []


@pytest.mark.parametrize("case", sorted(RUNS))
def test_outputs_bitwise_with_and_without_the_profiler(case):
    plain, traced, _ = runs(case)
    a, b = flat(plain), flat(traced)
    assert len(a) == len(b) >= 2
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_no_span_is_open_at_the_engines_yield(fresh):
    model = smoke_model()
    c = model.cfg
    g = torch.Generator().manual_seed(1)
    eng = ForecastEngine(model, EngineConfig(members=MEMBERS,
                                             lead_chunk=CHUNK))
    stream = eng.stream(
        model.make_buffers(),
        torch.randn((c.n_state, c.nlat, c.nlon), generator=g),
        torch.randn((LEADS, c.n_aux, c.nlat, c.nlon), generator=g),
        members_noise(model, 2))
    callers = []
    with profiled():
        for _ in stream:
            assert getattr(telemetry._open, "stack", []) == []
            assert all(s["t1"] is not None
                       for s in telemetry.process_trace().spans()[1:])
            with telemetry.span("bench.caller") as sp:
                callers.append(sp)
    spans = telemetry.process_spans()
    root = telemetry.process_trace().root
    mine = [s for s in spans if s["name"] == "bench.caller"]
    assert len(mine) == LEADS // CHUNK
    assert all(s["parent"] == root for s in mine)


# ---------------------------------------------------------------------------
# set-up spans


def test_plan_builds_are_recorded_without_a_profiler(fresh):
    assert not torch._C._autograd._profiler_enabled()
    gi, go = glib.make_grid(9, 16), glib.make_grid(5, 8, "gauss")
    # the builders under their caches: each call is a miss
    plan = discolib._cached_plan.__wrapped__(*discolib.plan_key(gi, go))
    plan.row_taps()
    leg._cached_table.__wrapped__(*leg.table_key(5, 5, go.colat))
    interplib.BilinearResample.create(go, gi)
    spans = telemetry.process_spans()
    assert [(s["name"], s["args"]["kind"]) for s in spans] == [
        ("plans.build", k) for k in ("disco", "disco_band", "disco_taps",
                                     "disco_row_taps", "legendre",
                                     "resample")]
    root = telemetry.process_trace().root
    assert all(s["parent"] == root and s["dur_s"] > 0
               and s["device_ms"] is None for s in spans)
    assert spans[0]["args"]["key"] == \
        "9x16 equiangular -> 5x8 gauss, 2/2/3.0"
    # the memo hits build nothing
    plan.row_taps()
    plan.banded_split()
    assert len(telemetry.process_spans()) == len(spans)


def test_kernel_loads_are_recorded_without_a_profiler(fresh, monkeypatch):
    built = []
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "build_all", lambda keys: built.extend(keys))
    monkeypatch.setattr(build.ctypes, "CDLL",
                        lambda path: types.SimpleNamespace(_name=path))
    exists = build._target("crps", (("TUNE_CRPS_THREADS", 256),)).exists()
    lib = build.load_library("crps", (("TUNE_CRPS_THREADS", 256),))
    assert build.load_library("crps", (("TUNE_CRPS_THREADS", 256),)) is lib
    assert built == [("crps", (("TUNE_CRPS_THREADS", 256),))]
    (s,) = telemetry.process_spans()
    assert s["name"] == "kernels.load" and s["dur_s"] >= 0
    assert s["args"] == {"name": "crps[TUNE_CRPS_THREADS=256]",
                         "built": not exists}


# ---------------------------------------------------------------------------
# the store


def test_request_trace_holds_at_most_its_capacity():
    tr = telemetry.RequestTrace("r", capacity=3)
    a = tr.begin("a")
    b = tr.add("b", 0.0, 1.0)
    assert (a, b) == (1, 2)
    assert tr.begin("c") is None and tr.add("d", 0.0, 1.0) is None
    tr.end(None)
    tr.end(a, {"k": 1})
    assert tr.dropped == 2
    spans = tr.spans()
    assert [s["name"] for s in spans] == ["request", "a", "b"]
    assert spans[1]["t1"] is not None and spans[1]["args"] == {"k": 1}


def test_process_trace_drops_past_its_capacity(fresh, monkeypatch):
    monkeypatch.setattr(telemetry, "PROCESS_SPAN_CAPACITY", 4)
    with profiled():
        for _ in range(5):
            with telemetry.span("engine.lead", member_leads=1):
                with telemetry.span("fcn3.forward"):
                    pass
    assert len(telemetry.process_spans()) == 3
    assert telemetry.process_trace().dropped == 7
    assert getattr(telemetry._open, "stack", []) == []


def test_end_closes_the_span_of_its_id():
    tr = telemetry.RequestTrace("r")
    ids = [tr.begin(f"s{i}") for i in range(200)]
    tr.end(ids[150], {"x": 1})
    spans = {s["id"]: s for s in tr.spans()}
    assert spans[ids[150]]["t1"] is not None
    assert spans[ids[150]]["args"] == {"x": 1}
    assert sum(s["t1"] is not None for s in spans.values()) == 1


# ---------------------------------------------------------------------------
# report_profile


def test_report_profile_takes_the_union_and_leaves_out_annotations():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, dev, a, b, ann=False):
        return types.SimpleNamespace(
            name=name, device_type=dev, is_user_annotation=ann,
            time_range=types.SimpleNamespace(
                start=a, end=b, elapsed_us=lambda: b - a))

    events = [ev("engine.lead", cpu, 0.0, 400.0, ann=True),
              # the range mirrored on the device's timeline
              ev("engine.lead", cuda, 0.0, 300.0),
              ev("fcn3.forward", cuda, 0.0, 300.0, ann=True),
              ev("gemm", cuda, 0.0, 100.0),
              ev("Memcpy HtoD", cuda, 50.0, 150.0),   # the copy stream
              ev("gemm", cuda, 200.0, 250.0)]
    lines = []
    got = lm.report_profile(types.SimpleNamespace(events=lambda: events),
                            1e-3, lines.append)
    # [0, 150] and [200, 250]: 200 us, not the 250 the durations sum to
    assert got["busy_s"] == pytest.approx(200e-6)
    assert "kernel_launches=3" in lines[0]
    assert "summed kernel time" in lines[1]
    assert [ln.split()[-1] for ln in lines[2:]] == ["gemm", "HtoD"]
    assert float(lines[2].split()[3].rstrip("%")) == pytest.approx(60.0)
    assert np.isclose(got["wall_s"], 1e-3)
