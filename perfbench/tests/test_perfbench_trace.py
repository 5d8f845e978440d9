"""The arithmetic of the per-layer metrics on synthetic traces: the busy
time is the union of every stream's intervals, and the shares of a peak
or a roofline follow from the fixed constants."""

import pytest

from perfbench import harness


def trace(events, window_s=10.0, host=()):
    return harness.Trace(window_s, sorted(events, key=lambda e: e[1]),
                         sorted(host, key=lambda e: e[1]))


def test_busy_is_the_union_of_two_overlapping_streams():
    compute = [("gemm_a", 0.0, 2.0), ("disco_band_kernel", 2.0, 3.0),
               ("sgemm_b", 5.0, 6.0)]
    copies = [("Memcpy HtoD", 1.5, 2.5), ("Memcpy HtoD", 2.9, 4.0)]
    t = trace(compute + copies)
    # [0, 4] and [5, 6]: 5 s, not the 6.1 s the durations sum to
    assert t.busy_s() == pytest.approx(5.0)
    idle = harness.metric_reader("idle_share.forecast")(
        {"trace": t, "config": {}, "work": {}})
    assert idle == pytest.approx(50.0)


def test_nested_and_contained_intervals_count_once():
    t = trace([("a", 0.0, 4.0), ("b", 1.0, 2.0), ("c", 3.5, 3.6)])
    assert t.busy_s() == pytest.approx(4.0)


def test_gaps_are_named_by_the_innermost_host_range():
    t = trace([("k", 0.0, 1.0), ("k", 3.0, 4.0), ("k", 4.5, 5.0)],
              host=[("bench.chunk", 0.0, 5.0), ("aten::copy_", 1.5, 2.5)])
    gaps = t.idle_gaps()
    assert gaps[0] == ["aten::copy_", pytest.approx(2.0)]
    assert gaps[1] == ["bench.chunk", pytest.approx(0.5)]


def test_gemm_ms_and_top_ops():
    t = trace([("ampere_sgemm_128x64_nn", 0.0, 0.3),
               ("cutlass_80_simt_sgemm", 0.3, 0.5),
               ("disco_band_kernel", 0.5, 0.6)])
    ms = harness.metric_reader("gemm_ms.forecast")(
        {"trace": t, "config": {}, "work": {"member_leads": 2}})
    assert ms == pytest.approx(250.0)
    assert t.top_ops(1) == [["ampere_sgemm_128x64_nn", pytest.approx(0.3)]]


def test_roofline_and_mfu_from_the_constants():
    cfg = {"work": {"model_flops_per_member_lead": 4.95e12,
                    "disco_forward": {"bound_s_per_member_lead": 0.001},
                    "model_flops_per_step": 9.9e12,
                    "disco_transpose": {"bound_s_per_step": 0.003}}}
    cfg["work"]["disco_forward"]["bound_s_per_step"] = 0.001
    t = trace([("disco_band_kernel", 0.0, 0.008),
               ("disco_band_bwd_kernel", 0.01, 0.018)], window_s=2.0)
    f = {"trace": t, "config": cfg, "work": {"member_leads": 4}}
    # the forward reader times the forward kernel alone
    assert harness.metric_reader("disco_roofline.forecast")(f) == \
        pytest.approx(100.0 * 0.004 / 0.008)
    # 4 member-leads of 4.95e12 FLOPs in 2 s at 495e12 FLOP/s
    assert harness.metric_reader("mfu.forecast")(f) == pytest.approx(2.0)
    s = {"trace": t, "config": cfg, "work": {"steps": 2}}
    assert harness.metric_reader("disco_roofline.train")(s) == \
        pytest.approx(100.0 * 0.008 / 0.016)
    assert harness.metric_reader("mfu.train")(s) == pytest.approx(2.0)


def test_readers_give_nothing_where_nothing_ran():
    t = trace([("elementwise_kernel", 0.0, 1.0)])
    ctx = {"trace": t, "config": {"work": {}}, "work": {"member_leads": 4}}
    for name in ("disco_roofline.forecast", "mfu.forecast",
                 "gemm_ms.forecast"):
        assert harness.metric_reader(name)(ctx) is None
    empty = {"trace": trace([]), "config": {}, "work": {}}
    assert harness.metric_reader("idle_share.train")(empty) is None
