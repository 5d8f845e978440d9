"""The per-layer metrics that read the program's spans: their arithmetic
on synthetic spans, None on a program without the span API (an older
commit), and the forecast's divisor, the member-leads the window's
``engine.lead`` spans count, against the mode's own count."""

import math

import pytest

from perfbench import harness
from perfbench import spans as spanlib
from perfbench.tests.smoke import smoke_cell
from repro_torch import telemetry

SEED = 2**31 + 977

FORECAST = ("encoder_ms.forecast", "local_blocks_ms.forecast",
            "global_blocks_ms.forecast", "decoder_ms.forecast",
            "engine_ms.forecast", "scores_ms.forecast",
            "stage_wait_ms.forecast")
TRAIN = ("forward_ms.train", "backward_ms.train", "adam_ms.train")
SETUP = ("setup_plans_s", "setup_kernels_s")


class Ids:
    def __init__(self):
        self.n = 0

    def __call__(self, name, /, parent=0, device_ms=None, dur_s=0.0,
                 **args):
        self.n += 1
        return {"id": self.n, "name": name, "parent": parent,
                "t0": 0.0, "t1": dur_s, "dur_s": dur_s, "tid": "main",
                "args": args, "device_ms": device_ms}


def forecast_spans() -> list[dict]:
    """Two leads of 4 member-leads each: the model's parts, the lead
    around them, the scores and a stage wait."""
    s = Ids()
    out = [s("engine.chunk", start=0, steps=2, batch=1)]
    out.append(s("engine.stage_wait", parent=1, device_ms=0.0))
    for _ in range(2):
        lead = s("engine.lead", parent=1, device_ms=800.0, member_leads=4)
        fwd = s("fcn3.forward", parent=lead["id"], device_ms=700.0)
        out += [lead, fwd,
                s("fcn3.encoder", parent=fwd["id"], device_ms=40.0),
                s("fcn3.block.global", parent=fwd["id"], device_ms=100.0,
                  index=0),
                s("fcn3.block.local", parent=fwd["id"], device_ms=60.0,
                  index=1),
                s("fcn3.block.local", parent=fwd["id"], device_ms=60.0,
                  index=2),
                s("fcn3.decoder", parent=fwd["id"], device_ms=440.0),
                s("engine.scores", parent=lead["id"], device_ms=20.0)]
    # set-up: a plan build inside another counts once with it
    outer = s("plans.build", dur_s=2.0, kind="disco")
    out += [outer, s("plans.build", parent=outer["id"], dur_s=0.5,
                     kind="disco_band"),
            s("plans.build", dur_s=1.0, kind="legendre"),
            s("kernels.load", dur_s=0.25, name="crps", built=True)]
    return out


def train_spans() -> list[dict]:
    s = Ids()
    out = []
    for _ in range(2):
        step = s("trainer.step", device_ms=7000.0)
        out += [step,
                s("trainer.forward", parent=step["id"], device_ms=1800.0),
                s("trainer.backward", parent=step["id"], device_ms=5000.0),
                s("trainer.adam", parent=step["id"], device_ms=50.0)]
    return out


def trace(host=()):
    return harness.Trace(10.0, [], sorted(host, key=lambda h: h[1]))


def read(name, ctx):
    return harness.metric_reader(name)(ctx)


def test_forecast_readers_on_synthetic_spans(monkeypatch):
    monkeypatch.setattr(telemetry, "process_spans", forecast_spans)
    ctx = {"trace": trace([("engine.stage_wait", 1.0, 1.004),
                           ("engine.stage_wait", 2.0, 2.002),
                           ("aten::copy_", 1.0, 3.0)]),
           "config": {}, "work": {"member_leads": 8}}
    got = {m: read(m, ctx) for m in FORECAST}
    # 8 member-leads: each part's two spans over 8
    assert got["encoder_ms.forecast"] == pytest.approx(80.0 / 8)
    assert got["global_blocks_ms.forecast"] == pytest.approx(200.0 / 8)
    assert got["local_blocks_ms.forecast"] == pytest.approx(240.0 / 8)
    assert got["decoder_ms.forecast"] == pytest.approx(880.0 / 8)
    # the lead less the model step: noise, casts and the scores
    assert got["engine_ms.forecast"] == pytest.approx(200.0 / 8)
    assert got["scores_ms.forecast"] == pytest.approx(40.0 / 8)
    # the profiler's host ranges of the wait, not the process trace's
    assert got["stage_wait_ms.forecast"] == pytest.approx(6.0 / 8)
    # the five model and engine metrics cover the leads' device time
    five = sum(got[m] for m in FORECAST[:5])
    assert five * 8 == pytest.approx(2 * 800.0)


def test_train_and_setup_readers_on_synthetic_spans(monkeypatch):
    monkeypatch.setattr(telemetry, "process_spans",
                        lambda: train_spans() + forecast_spans()[-4:])
    ctx = {"trace": trace(), "config": {}, "work": {"steps": 2}}
    assert read("forward_ms.train", ctx) == pytest.approx(1800.0)
    assert read("backward_ms.train", ctx) == pytest.approx(5000.0)
    assert read("adam_ms.train", ctx) == pytest.approx(50.0)
    assert read("setup_plans_s", ctx) == pytest.approx(3.0)
    assert read("setup_kernels_s", ctx) == pytest.approx(0.25)
    # no engine.lead span: the forecast readers give nothing
    assert all(read(m, ctx) is None for m in FORECAST)


def test_readers_give_none_on_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(telemetry, "process_spans")
    assert spanlib.program_spans() is None
    ctx = {"trace": trace([("engine.stage_wait", 1.0, 2.0)]), "config": {},
           "work": {"member_leads": 8, "steps": 2}}
    for m in FORECAST + TRAIN + SETUP:
        assert read(m, ctx) is None, m


def test_readers_give_none_where_a_span_lacks_device_time(monkeypatch):
    spans = forecast_spans()
    for s in spans:
        if s["name"] == "fcn3.encoder":
            s["device_ms"] = None          # a CPU run: no timing events
    monkeypatch.setattr(telemetry, "process_spans", lambda: spans)
    ctx = {"trace": trace(), "config": {}, "work": {}}
    assert read("encoder_ms.forecast", ctx) is None
    assert read("decoder_ms.forecast", ctx) == pytest.approx(110.0)
    assert read("stage_wait_ms.forecast", ctx) is None   # no such range


def test_member_leads_of_the_spans_are_the_modes(monkeypatch):
    """A traced smoke run on the CPU: the window's ``engine.lead`` spans
    count the member-leads the mode counts, and the readers that need no
    device time read finite values."""
    monkeypatch.setattr(telemetry, "_process", None)
    seen = {}
    result = harness.result

    def capture(cell, **kw):
        seen["work"] = kw["work"]
        seen["spans"] = telemetry.process_spans()
        return result(cell, **kw)

    monkeypatch.setattr(harness, "result", capture)
    cell = smoke_cell("forecast.e4_scored")
    res = harness.mode_module(cell.mode).run(
        cell, seed=SEED, seconds=0.5, trace=True, device="cpu", t0=0.0)
    assert res["correct"], res["checks"]
    n = spanlib.member_leads(seen["spans"])
    assert n == seen["work"]["member_leads"] > 0
    leads = [s for s in seen["spans"] if s["name"] == "engine.lead"]
    assert len(leads) == (cell.traffic["trace_chunks"]
                          * cell.traffic["lead_chunk"])
    for m in ("stage_wait_ms.forecast", "setup_plans_s"):
        assert math.isfinite(res["metrics"][m]["value"]), m
    assert res["metrics"]["setup_plans_s"]["value"] > 0


def test_gaps_are_put_under_the_innermost_program_span():
    from perfbench.tools import gaps
    t = harness.Trace(
        10.0, [("k", 0.0, 1.0), ("k", 3.0, 4.0), ("k", 4.5, 5.0),
               ("k", 5.1, 6.0)],
        sorted([("bench.chunk", 0.0, 6.0), ("engine.chunk", 0.0, 4.2),
                ("engine.stage_wait", 1.5, 2.5), ("aten::copy_", 1.9, 2.1),
                ("cudaStreamSynchronize", 4.3, 4.6)],
               key=lambda h: h[1]))
    names = {"engine.chunk", "engine.stage_wait"}
    got = gaps.program_gaps(t, names, 3)
    # the host's own innermost ranges (aten::copy_, the synchronize) are
    # passed over for the program's
    assert got == [["engine.stage_wait", pytest.approx(2.0)],
                   ["no program span", pytest.approx(0.5)],
                   ["no program span", pytest.approx(0.1)]]
    totals = gaps.span_totals(forecast_spans())
    assert totals["engine.lead"] == {"host_s": 0.0, "device_ms": 1600.0,
                                     "count": 2}
