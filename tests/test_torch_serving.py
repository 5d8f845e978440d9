"""The port's forecast service (``repro_torch.serving``) against the JAX
package's (``repro.serving``) on ``fcn3_smoke``, on the CPU.

* the wire contract: ``RequestSpec`` serializes and validates as the
  reference's, the NDJSON bytes of an event are the reference's, and the
  reference's client and reader read a port replica;
* served results: a port scheduler's forecast equals a direct port
  engine's with the same seed bitwise, coalesced requests hold the
  reference's dispatch bar against their serial runs (states rtol 1e-4 /
  atol 1e-5, scores rtol 1e-4 / atol 1e-6), and the port's scheduler on
  the reference's parameters, data and injected draws holds the same bar
  against the reference engine;
* the warm-key cache: hits and misses, a persisted library that will not
  load is quarantined, a readonly cache refuses instead of running nvcc;
* faults, QoS and observability: a retried request, the circuit breaker,
  deadline shedding, the span tree and ``/metrics``.

Every wait has a timeout of its own and every scheduler and server is
closed in a fixture's teardown, so a hang fails one test.
"""

import functools
import json
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
from _torch_threads import few_torch_threads  # noqa: F401

from repro.configs import fcn3 as jcfgs
from repro.core.fcn3 import FCN3 as JFCN3
from repro.data import era5_synthetic as jdata
from repro.inference import engine as jengine
from repro.serving import client as jclient
from repro.serving import spec as jspec
from repro.serving import transport as jtransport
from repro.train import checkpoint as jckpt
from repro_torch.core.fcn3 import FCN3 as TFCN3
from repro_torch.inference import params as tparams
from repro_torch.inference.engine import (ForecastEngine, InjectedNoise,
                                          members_noise)
from repro_torch.kernels import build
from repro_torch.serving import scheduler as schedlib
from repro_torch.serving import transport
from repro_torch.serving.cache import (ExecutableCache, ExecutableKey,
                                       ReadOnlyCacheMiss)
from repro_torch.serving.client import ForecastClient
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.observability import ObservabilityConfig
from repro_torch.serving.scheduler import ForecastScheduler, ModelPool
from repro_torch.serving.service import ForecastService
from repro_torch.serving.spec import RequestSpec
from repro_torch.telemetry import parse_prometheus, prom_value

SPEC = RequestSpec(config="smoke", members=2, lead_steps=3, lead_chunk=2,
                   scored=True, return_state=True)
#: the reference's dispatch bar (tests/test_kernel_dispatch.py:289)
STATE_RTOL, STATE_ATOL, SCORE_RTOL, SCORE_ATOL = 1e-4, 1e-5, 1e-4, 1e-6
WAIT_S = 120.0


def _wait(fn, timeout: float = WAIT_S):
    """``fn()`` on a thread, joined with a timeout: its result, or its
    exception re-raised; a hang fails the test instead of the suite."""
    box: dict = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"no result within {timeout}s"
    if "error" in box:
        raise box["error"]
    return box["value"]


def _served(stream):
    return _wait(stream.result)


def _spec(**kw) -> RequestSpec:
    return RequestSpec(**{**SPEC.to_dict(), **kw})


def _direct(bundle, spec: RequestSpec):
    """A direct port engine's forecast for ``spec`` on the pool's model."""
    eng = ForecastEngine(bundle.model, spec.engine_config())
    ds = bundle.ds
    return eng.forecast(bundle.buffers, ds.state(spec.sample, 0),
                        lambda n: ds.aux_fields(6.0 * (n + 1)),
                        members_noise(bundle.model, spec.seed),
                        steps=spec.lead_steps,
                        truth=lambda n: ds.state(spec.sample, n + 1))


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def pool():
    return ModelPool(device="cpu")


@pytest.fixture(scope="module")
def sched(pool):
    s = ForecastScheduler(pool=pool, cache=ExecutableCache(),
                          max_concurrency=1)
    yield s
    s.close(timeout=30)


@pytest.fixture(scope="module")
def direct(pool):
    return _direct(pool.get("smoke"), SPEC)


@pytest.fixture(scope="module")
def server(sched):
    srv = ForecastService(scheduler=sched).make_server(port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


def test_client_side_imports_no_jax():
    code = ("import sys; import repro_torch.serving, repro_torch.telemetry; "
            "import repro_torch.serving.client; "
            "print('jax' in sys.modules, 'repro' in sys.modules)")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, check=True)
    assert out.stdout.split() == ["False", "False"]


class TestRequestSpec:
    FIELDS = [{}, {"members": 4, "lead_steps": 8, "precision": "bfloat16"},
              {"perturb": "bred", "bred_cycles": 2, "members": 4,
               "ensemble_transform": True, "kernels": "pallas"},
              {"priority": "interactive", "deadline_ms": 250.0,
               "degrade": True, "max_retries": 3, "profile": True}]

    @pytest.mark.parametrize("fields", FIELDS)
    def test_to_dict_is_the_reference_body(self, fields):
        got = RequestSpec(**fields).to_dict()
        assert got == jspec.RequestSpec(**fields).to_dict()
        assert json.dumps(got) == json.dumps(
            jspec.RequestSpec(**fields).to_dict())
        assert RequestSpec.from_dict(got) == RequestSpec(**fields)

    BAD = [{"members": 3}, {"config": "huge"}, {"lead_steps": 0},
           {"lead_chunk": 0}, {"precision": "fp8"}, {"kernels": "triton"},
           {"priority": "urgent"}, {"deadline_ms": -1.0},
           {"max_retries": 9}, {"members": 2.0}, {"scored": 1},
           {"perturb": "gaussian"},
           {"perturb": "obs", "ensemble_transform": True}]

    @pytest.mark.parametrize("fields", BAD)
    def test_validate_refuses_what_the_reference_refuses(self, fields):
        with pytest.raises(ValueError) as want:
            jspec.RequestSpec(**fields).validate()
        with pytest.raises(ValueError) as got:
            RequestSpec(**fields).validate()
        assert str(got.value) == str(want.value)

    def test_unknown_field_refused_by_name(self):
        with pytest.raises(ValueError, match="nonsense"):
            RequestSpec.from_dict({"nonsense": 1})

    def test_keys_leave_qos_fields_out(self):
        qos = _spec(priority="interactive", deadline_ms=5.0, degrade=True,
                    profile=True, max_retries=4, sample=9, seed=1,
                    coalesce=False)
        assert qos.engine_key() == SPEC.engine_key()
        assert qos.batch_key() == SPEC.batch_key()
        assert _spec(lead_steps=5).batch_key() != SPEC.batch_key()
        assert _spec(members=4).engine_key() != SPEC.engine_key()

    def test_kernel_modes_map_to_the_port(self):
        assert SPEC.engine_config().kernels is None
        ref = _spec(kernels="reference").engine_config().kernels
        pal = _spec(kernels="pallas").engine_config().kernels
        assert (ref.sht, ref.disco) == ("reference", "reference")
        assert (pal.sht, pal.disco) == ("kernel", "kernel")


class TestTransport:
    def _payload(self):
        r = np.random.default_rng(0)
        block = type("Block", (), {
            "lead_steps": np.arange(2, 4),
            "scores": {"crps": r.standard_normal((2, 17)).astype(np.float32),
                       "rank_hist": r.random((2, 17, 3)).astype(np.float32)}})
        state = r.standard_normal((2, 17, 33, 64)).astype(np.float32)
        return block, state

    def test_event_bytes_are_the_reference_bytes(self):
        block, state = self._payload()
        for mod_ in (transport, jtransport):
            assert mod_.NDJSON_MIME == "application/x-ndjson"
        got = transport.dump_event(transport.chunk_event("r1", 1, block))
        want = jtransport.dump_event(jtransport.chunk_event("r1", 1, block))
        assert got == want
        done = {"event": "done", "request_id": "r1",
                "final_state": transport.encode_array(state)}
        want = {**done, "final_state": jtransport.encode_array(state)}
        assert transport.dump_event(done) == jtransport.dump_event(want)

    def test_port_reader_parses_the_reference_lines(self):
        # the reader cuts base64 texts out before the parse: every line
        # the reference writes (a state, nested and empty texts, a string
        # holding the key's bytes) parses as json.loads parses it, and a
        # line cut short is a StreamInterrupted
        import io
        _, state = self._payload()
        evs = [{"event": "done", "request_id": "r1",
                "final_state": jtransport.encode_array(state)},
               {"event": "x", "l": [{"b64": ""}, [{"k": 1, "b64": "QUJD"}]],
                "z": {"q": {"b64": "AAAA"}, "b64": "BBBB"}},
               {"event": "chunk", "s": '"b64":"x"', "t": "b64"}]
        raw = b"".join(jtransport.dump_event(ev) for ev in evs)
        got = list(transport.read_events(io.BytesIO(raw)))
        assert got == [json.loads(jtransport.dump_event(ev)) for ev in evs]
        np.testing.assert_array_equal(
            transport.decode_array(got[0]["final_state"]), state)
        cut = jtransport.dump_event(evs[0])[:-40] + b"\n"
        with pytest.raises(transport.StreamInterrupted):
            list(transport.read_events(io.BytesIO(cut)))

    def test_reference_reader_decodes_a_port_stream(self, sched, direct):
        import io
        raw = b"".join(transport.dump_event(ev)
                       for ev in _wait(lambda: list(
                           sched.submit(SPEC).events())))
        res = jtransport.collect(jtransport.read_events(io.BytesIO(raw)))
        for name, arr in direct.scores.items():
            np.testing.assert_array_equal(res.scores[name], arr.numpy(),
                                          err_msg=name)
        np.testing.assert_array_equal(res.final_state,
                                      direct.final_state.numpy())


class TestServed:
    def test_served_bit_identical_to_direct(self, sched, direct):
        events = _wait(lambda: list(sched.submit(SPEC).events()))
        res = transport.collect(iter(json.loads(transport.dump_event(ev))
                                     for ev in events))
        assert res.lead_steps.tolist() == [0, 1, 2]
        assert [c["lead_steps"] for c in res.chunks] == [[0, 1], [2]]
        for name, arr in direct.scores.items():
            np.testing.assert_array_equal(res.scores[name], arr.numpy(),
                                          err_msg=name)
        np.testing.assert_array_equal(res.final_state,
                                      direct.final_state.numpy())

    def test_warm_request_reports_zero_compile(self, sched):
        _served(sched.submit(SPEC))
        before = sched.cache.stats()["misses"]
        res = _served(sched.submit(SPEC))
        assert res.timing["compile_s"] == 0.0
        assert res.cache == {"hits": 2, "misses": 0}
        assert sched.cache.stats()["misses"] == before
        assert set(res.timing) == {"queue_s", "setup_s", "compile_s",
                                   "run_s", "total_s", "chunk_s",
                                   "batch_size"}

    def test_unscored_request_streams_without_scores(self, sched):
        res = _served(sched.submit(_spec(scored=False)))
        assert res.scores == {} and res.final_state is not None

    def test_runtime_error_reaches_stream(self, sched, monkeypatch):
        monkeypatch.setattr(
            sched.cache, "warm_engine",
            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
        with pytest.raises(transport.ServingError, match="boom"):
            _served(sched.submit(_spec(seed=123)))

    def test_coalesced_within_bar_of_serial(self, pool):
        specs = [_spec(sample=3, seed=9), _spec(sample=5, seed=1)]
        s = ForecastScheduler(pool=pool, cache=ExecutableCache(),
                              max_batch=2, batch_window_ms=5000.0)
        try:
            streams = [s.submit(sp) for sp in specs]
            got = [_served(st) for st in streams]
            assert [r.batch_size for r in got] == [2, 2]
            assert s.stats()["batches"] == {"2": 1}
        finally:
            s.close(timeout=30)
        b = pool.get("smoke")
        for r, (res, sp) in enumerate(zip(got, specs)):
            want = _direct(b, sp)
            _close(res.final_state, want.final_state, STATE_RTOL,
                   STATE_ATOL, f"request {r}")
            for name, arr in want.scores.items():
                atol = STATE_ATOL if name == "rank_hist" else SCORE_ATOL
                _close(res.scores[name], arr, SCORE_RTOL, atol, name)
        assert np.abs(got[0].final_state - got[1].final_state).max() > 0.1


class TestHTTP:
    def test_port_client_streams_chunk_by_chunk(self, server):
        c = ForecastClient(port=server.server_address[1], timeout=WAIT_S)
        assert c.health() == {"ok": True}
        kinds = [e["event"] for e in c.stream(SPEC)]
        assert kinds == ["start", "chunk", "chunk", "done"]

    def test_reference_client_reads_a_port_replica(self, server, direct):
        c = jclient.ForecastClient(port=server.server_address[1],
                                   timeout=WAIT_S, connect_timeout=10.0)
        res = c.forecast(jspec.RequestSpec(**SPEC.to_dict()))
        assert isinstance(res, jtransport.ServedForecast)
        for name, arr in direct.scores.items():
            np.testing.assert_array_equal(res.scores[name], arr.numpy(),
                                          err_msg=name)
        np.testing.assert_array_equal(res.final_state,
                                      direct.final_state.numpy())

    def test_invalid_spec_is_400_and_unknown_route_404(self, server):
        c = ForecastClient(port=server.server_address[1], timeout=WAIT_S)
        with pytest.raises(transport.ServingError, match="400.*even"):
            list(c.stream({"members": 3}))
        with pytest.raises(transport.ServingError, match="404"):
            c._get_json("/v1/nope")

    def test_metrics_parse_and_agree_with_stats(self, server):
        c = ForecastClient(port=server.server_address[1], timeout=WAIT_S)
        before = c.stats()["served"]
        list(c.stream(SPEC))
        # the scheduler counts a batch served when it returns, just after
        # the stream's last event: read both once the count has risen
        deadline = time.monotonic() + WAIT_S
        while c.stats()["served"] <= before:
            assert time.monotonic() < deadline, "the served count never rose"
            time.sleep(0.01)
        stats = c.stats()
        parsed = parse_prometheus(c.metrics())

        def pv(name, **labels):
            return prom_value(parsed, f"fcn3_serving_{name}", **labels)

        assert pv("requests_served_total") == stats["served"] > 0
        assert pv("cache_misses_total") == stats["cache"]["misses"]
        assert pv("cache_hits_total") == stats["cache"]["hits"]
        assert pv("engine_pool_engines") == stats["pool"]["engines"]
        assert pv("engine_dispatch_total", path="chunks") > 0
        for size, n in stats["batches"].items():
            assert pv("batches_total", size=size) == n


class TestObservability:
    def test_span_tree_names(self, pool, tmp_path):
        s = ForecastScheduler(pool=pool, cache=ExecutableCache(),
                              observability=ObservabilityConfig(
                                  trace_dir=str(tmp_path)))
        try:
            res = _served(s.submit(SPEC))
            trace = s.trace_json(res.request_id)
        finally:
            s.close(timeout=30)
        names = {e["name"] for e in trace["traceEvents"]
                 if e.get("ph") == "X"}
        required = {"request", "admit", "queue", "coalesce", "engine_build",
                    "inputs", "rollout", "chunk[0]", "chunk[1]",
                    "stage_h2d", "score_fetch", "encode", "finalize"}
        assert required <= names, names
        assert "compile" in names
        assert (tmp_path / f"{res.request_id}.trace.json").exists()

    def test_trace_on_disk_when_result_returns(self, pool, tmp_path):
        # the trace is dumped before the terminal event is delivered: the
        # file is there as soon as result() returns, without close()
        s = ForecastScheduler(pool=pool, cache=ExecutableCache(),
                              observability=ObservabilityConfig(
                                  trace_dir=str(tmp_path)))
        try:
            for seed in range(4):
                stream = s.submit(_spec(seed=seed, lead_steps=1,
                                        lead_chunk=1))
                res = _served(stream)
                path = tmp_path / f"{res.request_id}.trace.json"
                assert path.exists(), seed
                assert json.loads(path.read_text())["traceEvents"]
                # a second finish neither delivers nor dumps again
                mtime = path.stat().st_mtime_ns
                assert not s._finish(stream, {"event": "done"})
                assert path.stat().st_mtime_ns == mtime
        finally:
            s.close(timeout=30)

    def test_profiled_request_exports_a_chrome_trace(self, pool, direct,
                                                     tmp_path):
        s = ForecastScheduler(pool=pool, cache=ExecutableCache(),
                              observability=ObservabilityConfig(
                                  profile_dir=str(tmp_path)))
        try:
            res = _served(s.submit(_spec(profile=True)))
        finally:
            s.close(timeout=30)
        events = json.loads((tmp_path / f"{res.request_id}.trace.json")
                            .read_text())["traceEvents"]
        assert events
        np.testing.assert_array_equal(res.scores["crps"],
                                      direct.scores["crps"].numpy())


class TestFaultsAndQos:
    def test_transient_fault_retried_bit_identically(self, pool, direct):
        s = ForecastScheduler(pool=pool, cache=ExecutableCache(),
                              faults=FaultInjector.from_args(
                                  ["rollout_chunk:n=1"]),
                              retry_backoff_ms=1.0)
        try:
            events = _wait(lambda: list(s.submit(
                _spec(max_retries=2)).events()))
            assert [e["event"] for e in events] == ["start", "chunk",
                                                    "chunk", "done"]
            res = transport.collect(iter(events))
            assert res.retries == 1
            assert s.stats()["fault_tolerance"]["retries"] == 1
        finally:
            s.close(timeout=30)
        for name, arr in direct.scores.items():
            np.testing.assert_array_equal(res.scores[name], arr.numpy())

    def test_breaker_opens_after_threshold(self, pool):
        s = ForecastScheduler(pool=pool, cache=ExecutableCache(),
                              faults=FaultInjector.from_args(
                                  ["compile:first=5,kind=permanent"]),
                              breaker_threshold=2, breaker_cooldown_s=1e9)
        try:
            for _ in range(2):
                with pytest.raises(transport.ServingError,
                                   match="injected permanent fault"):
                    _served(s.submit(SPEC))
            with pytest.raises(transport.ServingError) as e:
                _served(s.submit(SPEC))
            assert e.value.reason == "circuit_open"
            ft = s.stats()["fault_tolerance"]
            assert ft["circuit_open_shed"] == 1
            assert ft["faults"]["occurrences"]["compile"] == 2
            (label, snap), = ft["breakers"].items()
            assert snap["state"] == "open" and label.startswith("smoke/")
            assert ft["health"]["state"] == "degraded"
        finally:
            s.close(timeout=30)

    def test_expired_deadline_shed_before_rollout(self, pool):
        s = ForecastScheduler(pool=pool, cache=ExecutableCache(),
                              max_concurrency=1)
        gate = threading.Event()
        orig = s._dispatch

        def held(batch):
            gate.wait(WAIT_S)
            return orig(batch)

        s._dispatch = held
        try:
            first = s.submit(SPEC)
            late = s.submit(_spec(deadline_ms=1.0, seed=3))
            threading.Timer(0.2, gate.set).start()
            assert not _served(first).cancelled
            with pytest.raises(transport.ServingError) as e:
                _served(late)
            assert e.value.reason == "deadline"
            stats = s.stats()
            assert stats["qos"]["shed"] == {"batch": 1}
            assert stats["batches"] == {"1": 1}
        finally:
            gate.set()
            s.close(timeout=30)


class _StubEngine:
    """A warm target whose path needs one kernel library."""

    def __init__(self, libs=("legendre",)):
        self.libs, self.warm = libs, set()
        self.cfg = SPEC.engine_config()

    def kernel_libraries(self):
        return self.libs

    def make_resident(self, buffers):
        pass

    def mark_warm(self, scored, k, batch=None):
        self.warm.add((scored, k, batch))

    def is_warm(self, scored, k, buffers, batch=None):
        return (scored, k, batch) in self.warm

    def chunk_lengths(self, steps):
        return [2, 1]


class TestCache:
    def test_hits_and_misses(self, pool):
        b = pool.get("smoke")
        eng = ForecastEngine(b.model, _spec(members=4).engine_config())
        cache = ExecutableCache()
        first = cache.warm_engine("smoke", eng, True, 3, b.buffers)
        assert [o["source"] for o in first["outcomes"]] == ["compiled"] * 2
        again = cache.warm_engine("smoke", eng, True, 3, b.buffers)
        assert again["compile_s"] == 0.0 and again["hits"] == 2
        assert cache.stats()["misses"] == 2 and cache.stats()["keys"] == 2
        # the coalesced keys are keys of their own
        batched = cache.warm_engine("smoke", eng, True, 3, b.buffers,
                                    batch=2)
        assert batched["misses"] == 2
        assert eng.estimated_bytes() > 0

    def test_key_token_scoped_by_environment(self):
        key = ExecutableKey("smoke", 2, True, (1, 2), None)
        assert key.token("cpu") == key.token("cpu")
        assert key.token("cpu") != ExecutableKey("smoke", 1, True, (1, 2),
                                                 None).token("cpu")

    def test_unloadable_library_quarantined_then_build_refused(
            self, tmp_path):
        # no nvcc here: after the quarantine the rebuild raises, and a
        # failed build is never a silent fallback
        path = tmp_path / build.library_file("legendre")
        path.write_bytes(b"not a shared object")
        cache = ExecutableCache(persist_dir=str(tmp_path))
        key = ExecutableKey("smoke", 2, True, (), None)
        assert not build.is_loaded("legendre")
        with pytest.raises(RuntimeError, match="nvcc"):
            cache.warm(key, _StubEngine(), {})
        assert cache.stats()["quarantined"] == 1
        assert (tmp_path / (path.name + ".corrupt")).exists()

    def test_readonly_refuses_instead_of_nvcc(self, tmp_path):
        cache = ExecutableCache(persist_dir=str(tmp_path), readonly=True)
        key = ExecutableKey("smoke", 2, True, (), None)
        with pytest.raises(ReadOnlyCacheMiss, match="refusing to run nvcc"):
            cache.warm(key, _StubEngine(), {})
        with pytest.raises(ReadOnlyCacheMiss, match="geometry plan"):
            cache.require_plans("small")
        assert cache.stats()["misses"] == 0

    def test_library_from_another_directory_checks_its_hash(self, tmp_path):
        (tmp_path / "liblegendre-000000000000.so").write_bytes(b"x")
        with pytest.raises(FileNotFoundError, match="other sources"):
            build.load_library_from("legendre", tmp_path)


# ---------------------------------------------------------------------------
# the port's scheduler against the reference engine


@pytest.fixture(scope="module")
def ref():
    """The JAX model, its parameters and data on ``fcn3_smoke``."""
    cfg = jcfgs.fcn3_smoke()
    model = JFCN3(cfg)
    params = model.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v)
            for k, v in jckpt._flatten_with_paths(params).items()}
    return {"model": model, "params": params, "flat": flat,
            "bufs": model.make_buffers(), "ds": jdata.SyntheticERA5(cfg)}


class _ReferenceData:
    """The reference's synthetic ERA5 as the port's scheduler reads it."""

    def __init__(self, ds):
        self.ds = ds

    @functools.lru_cache(maxsize=None)
    def state(self, sample: int, n: int = 0) -> torch.Tensor:
        return torch.from_numpy(np.array(self.ds.state(sample, n)))

    @functools.lru_cache(maxsize=None)
    def aux_fields(self, t: float) -> torch.Tensor:
        return torch.from_numpy(np.array(self.ds.aux_fields(t)))


def _reference_draws(ref, seed: int, members: int, steps: int):
    """The reference engine's draws for ``PRNGKey(seed)``."""
    m, key = ref["model"], jax.random.PRNGKey(seed)
    nb = m.noise.buffers()
    z0 = np.asarray(m.noise.init_state(key, (members,), nb))
    etas = [np.asarray(m.noise._sample_coeffs(
        jax.random.fold_in(key, n), (members,), nb["sigma_l"]))
        for n in range(steps)]
    return InjectedNoise(z0, etas)


class TestAgainstReference:
    SPECS = [_spec(sample=11, seed=3), _spec(sample=12, seed=5)]

    @pytest.fixture(scope="class")
    def served(self, ref, monkeypatch_class):
        def bundle(name, ckpt=None, device="cpu"):
            model = TFCN3(schedlib.fcn3cfg.NAMED_CONFIGS[name](),
                          device="cpu")
            tparams.load_into(model, ref["flat"])
            return schedlib.ModelBundle(name, model, _ReferenceData(ref["ds"]),
                                        model.make_buffers())

        monkeypatch_class.setattr(schedlib, "build_bundle", bundle)
        monkeypatch_class.setattr(
            schedlib, "request_noise",
            lambda model, seed: _reference_draws(ref, seed, SPEC.members,
                                                 SPEC.lead_steps))
        s = ForecastScheduler(pool=ModelPool(device="cpu"),
                              cache=ExecutableCache(), max_batch=2,
                              batch_window_ms=5000.0)
        try:
            solo = _served(s.submit(self.SPECS[0]))
            pair = [s.submit(sp) for sp in self.SPECS]
            pair = [_served(st) for st in pair]
        finally:
            s.close(timeout=30)
        assert solo.batch_size == 1 and [r.batch_size for r in pair] == [2, 2]
        return [solo] + pair

    @pytest.fixture(scope="class")
    def want(self, ref):
        ds = ref["ds"]
        eng = jengine.ForecastEngine(ref["model"], jengine.EngineConfig(
            members=SPEC.members, lead_chunk=SPEC.lead_chunk))
        out = []
        for sp in self.SPECS:
            out.append(eng.forecast(
                ref["params"], ref["bufs"], ds.state(sp.sample, 0),
                lambda n: ds.aux_fields(6.0 * (n + 1)),
                jax.random.PRNGKey(sp.seed), steps=sp.lead_steps,
                truth=lambda n, sm=sp.sample: ds.state(sm, n + 1)))
        return out

    @pytest.mark.parametrize("which", ["solo", "coalesced0", "coalesced1"])
    def test_state_and_scores_within_bar(self, served, want, which):
        i = ["solo", "coalesced0", "coalesced1"].index(which)
        got, w = served[i], want[max(0, i - 1)]
        _close(got.final_state, w.final_state, STATE_RTOL, STATE_ATOL)
        assert set(got.scores) == set(w.scores)
        for name, arr in w.scores.items():
            atol = STATE_ATOL if name == "rank_hist" else SCORE_ATOL
            _close(got.scores[name], arr, SCORE_RTOL, atol, name)


@pytest.fixture(scope="class")
def monkeypatch_class():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_service_cli_runs_on_cuda_unless_asked_for_the_cpu(capsys):
    from repro_torch.launch import service as service_cli
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(SystemExit) as e:
        service_cli.main(["--port", "0"])
    assert e.value.code == 2
    assert "CUDA" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        service_cli.main(["--tune"])
    assert e.value.code == 2
