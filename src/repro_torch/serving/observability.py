"""Observability hub for the serving stack: metrics, traces, flight ring.

One ``Observability`` object per scheduler is the single instrumentation
substrate: the scheduler's QoS/batch counters live here as
registry instruments (``/v1/stats`` reads them back, so the two views
cannot drift), the engine pool / executable cache / engines export their
authoritative tallies via collector callbacks, request span trees are
recorded against monotonic clocks and exported as Chrome/Perfetto JSON
(``GET /v1/trace/<request_id>``, ``--trace-dir``), opt-in
``torch.profiler`` sessions wrap a traced request's rollout, and a bounded
flight recorder keeps the last N request lifecycle event sequences for
post-mortem (``GET /v1/debug/requests``).

Cost discipline:

* **Free when disabled.** ``ObservabilityConfig(enabled=False)`` makes
  ``begin_trace`` return ``NULL_TRACE`` (every span call a no-op) and
  turns flight recording into an early-return; the scheduler guards its
  only per-chunk clock reads on the same flag, so the disabled dispatch
  path is structurally the uninstrumented one.
* **Bit-identical always.** Instrumentation only reads clocks and
  copies already-computed values; the traced, profiled and untraced
  paths launch the same kernels in the same order
  (``tests/test_torch_serving.py`` holds a profiled request to the
  direct engine exactly), and neither ``profile`` nor any trace state
  enters ``engine_key``/``batch_key``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import os
import threading
import time

from repro_torch.telemetry import (MetricsRegistry, NULL_TRACE, RequestTrace,
                             setup_logging)

__all__ = ["ObservabilityConfig", "Observability", "FlightRecorder",
           "NULL_TRACE", "RequestTrace", "setup_logging", "METRIC_PREFIX"]

_log = logging.getLogger("repro_torch.serving.observability")

#: every serving metric name starts with this.
METRIC_PREFIX = "fcn3_serving_"


@dataclasses.dataclass
class ObservabilityConfig:
    """Knobs for one scheduler's observability layer.

    ``enabled`` is the master switch for tracing and flight recording
    (metrics stay on: they are the source of truth behind
    ``/v1/stats``).  ``trace_dir`` additionally dumps each finished
    request's Chrome trace JSON to disk; ``profile_dir`` enables the
    opt-in per-request ``torch.profiler`` hook (requests asking
    ``"profile": true`` are refused nothing -- the field is simply
    inert without a directory).
    """

    enabled: bool = True
    trace_dir: str | None = None
    profile_dir: str | None = None
    #: finished traces kept in memory for ``GET /v1/trace/<id>``
    trace_capacity: int = 256
    #: finished request entries kept in the flight ring
    flight_capacity: int = 256
    #: lifecycle events kept per request before counting drops
    flight_events: int = 64


class FlightRecorder:
    """Bounded ring of request lifecycle event sequences.

    Each request gets one entry (``start``) that accumulates timestamped
    events (``record``) until ``finish`` moves it into the finished
    ring.  Both the per-request event list and the active/finished sets
    are bounded, so a flood of requests (or a leak that never finishes
    one) cannot grow memory: oldest entries fall off, a per-entry
    ``dropped`` counter says how many events were discarded.
    """

    def __init__(self, capacity: int = 256, max_events: int = 64):
        """Create an empty recorder with the given bounds."""
        self.capacity = int(capacity)
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        self._active: collections.OrderedDict[str, dict] = \
            collections.OrderedDict()
        self._finished: collections.deque[dict] = \
            collections.deque(maxlen=self.capacity)

    def start(self, request_id: str, summary: dict | None = None) -> None:
        """Open an entry for ``request_id`` (evicts the oldest active)."""
        entry = {"request_id": request_id, "t0_unix_s": time.time(),
                 "_t0": time.perf_counter(), "spec": dict(summary or {}),
                 "events": [], "dropped": 0, "outcome": None}
        with self._lock:
            self._active[request_id] = entry
            while len(self._active) > self.capacity:
                _, old = self._active.popitem(last=False)
                old["outcome"] = old["outcome"] or "evicted"
                self._finished.append(old)

    def record(self, request_id: str, event: str, **fields) -> None:
        """Append one event to the request's entry (bounded)."""
        with self._lock:
            entry = self._active.get(request_id)
            if entry is None:
                return
            if len(entry["events"]) >= self.max_events:
                entry["dropped"] += 1
                return
            ev = {"dt_s": round(time.perf_counter() - entry["_t0"], 6),
                  "event": event}
            ev.update(fields)
            entry["events"].append(ev)

    def finish(self, request_id: str, outcome: str) -> None:
        """Move the request's entry into the finished ring."""
        with self._lock:
            entry = self._active.pop(request_id, None)
            if entry is None:
                return
            entry["outcome"] = outcome
            self._finished.append(entry)

    def snapshot(self) -> dict:
        """Copies of the active and finished entries (private keys
        stripped), newest finished last."""
        def clean(e):
            return {k: (list(v) if k == "events" else v)
                    for k, v in e.items() if not k.startswith("_")}
        with self._lock:
            return {"active": [clean(e) for e in self._active.values()],
                    "finished": [clean(e) for e in self._finished],
                    "capacity": self.capacity,
                    "max_events": self.max_events}


class Observability:
    """Per-scheduler instrumentation hub (see module docstring).

    Owns the ``MetricsRegistry``, the scheduler's pre-created
    instruments, the in-memory trace store, the flight recorder and the
    process-wide profiler guard.  The scheduler writes counters through
    the instrument attributes below and reads them back for
    ``/v1/stats`` -- there is no second tally to drift.
    """

    def __init__(self, config: ObservabilityConfig | None = None,
                 registry: MetricsRegistry | None = None):
        """Build the hub and pre-create every scheduler instrument."""
        self.config = config or ObservabilityConfig()
        self.metrics = registry or MetricsRegistry()
        self.flight = FlightRecorder(self.config.flight_capacity,
                                     self.config.flight_events)
        self._traces: collections.OrderedDict[str, RequestTrace] = \
            collections.OrderedDict()
        self._trace_lock = threading.Lock()
        self._prof_lock = threading.Lock()

        m, p = self.metrics, METRIC_PREFIX
        self.served = m.counter(
            p + "requests_served_total",
            "Requests whose dispatch completed (including cancelled)")
        self.failed = m.counter(
            p + "requests_failed_total",
            "Requests whose dispatch raised")
        self.shed = m.counter(
            p + "qos_shed_total",
            "Requests shed unserved at pickup (deadline passed)",
            ("priority",))
        self.degraded = m.counter(
            p + "qos_degraded_total",
            "Requests served at the degraded member floor", ("priority",))
        self.requeued = m.counter(
            p + "qos_requeued_total",
            "Stragglers parked back in the queue at pickup", ("priority",))
        self.cancelled_queued = m.counter(
            p + "qos_cancelled_queued_total",
            "Requests cancelled while still queued", ("priority",))
        self.batch_shrinks = m.counter(
            p + "batch_shrinks_total",
            "Batched rollouts shrunk onto the surviving requests mid-run")
        self.batches = m.counter(
            p + "batches_total",
            "Dispatched rollouts by coalesced batch size", ("size",))
        self.queue_seconds = m.histogram(
            p + "request_queue_seconds",
            "Seconds from submit to pickup", ("priority",))
        self.total_seconds = m.histogram(
            p + "request_total_seconds",
            "Seconds from pickup to done", ("priority",))
        self.h2d_seconds = m.histogram(
            p + "h2d_stage_seconds",
            "Seconds materializing one chunk's host slices (stager)")
        self.traces = m.counter(
            p + "traces_total", "Request traces recorded")
        self.profiles = m.counter(
            p + "profiles_total", "torch.profiler sessions captured")
        self.retries = m.counter(
            p + "retries_total",
            "Request re-dispatches after a transient failure")
        self.worker_restarts = m.counter(
            p + "worker_restarts_total",
            "Crashed worker threads restarted by the supervisor")
        self.circuit_open_shed = m.counter(
            p + "circuit_open_shed_total",
            "Requests shed fast because their engine key's circuit was open")
        self.stream_disconnects = m.counter(
            p + "stream_disconnects_total",
            "Client connections that dropped mid-stream")
        self.stream_resumes = m.counter(
            p + "stream_resumes_total",
            "Streams resumed via GET /v1/stream/<id>?from=<seq>")

    # -- tracing ----------------------------------------------------------

    @property
    def enabled(self) -> bool:
        """Master switch: tracing + flight recording on."""
        return self.config.enabled

    def begin_trace(self, request_id: str, meta: dict | None = None,
                    t0: float | None = None):
        """Open (and store) a trace; ``NULL_TRACE`` when disabled.

        ``t0`` backdates the root to an earlier ``perf_counter`` reading
        (admission starts before the trace object exists).
        """
        if not self.config.enabled:
            return NULL_TRACE
        tr = RequestTrace(request_id, meta, t0=t0)
        with self._trace_lock:
            self._traces[request_id] = tr
            while len(self._traces) > self.config.trace_capacity:
                self._traces.popitem(last=False)
        self.traces.inc()
        return tr

    def finish_trace(self, trace) -> None:
        """Close a trace's root span and dump it to ``trace_dir``."""
        if trace is NULL_TRACE:
            return
        trace.finish()
        self.dump_trace(trace)

    def dump_trace(self, trace) -> str | None:
        """Write (or re-write) the Chrome JSON to ``trace_dir``."""
        d = self.config.trace_dir
        if not d or trace is NULL_TRACE:
            return None
        import json
        try:
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"{trace.request_id}.trace.json")
            with open(path, "w") as f:
                json.dump(trace.to_chrome(), f)
            return path
        except OSError as e:
            _log.warning("failed to dump trace for %s: %s",
                         trace.request_id, e)
            return None

    def trace_json(self, request_id: str) -> dict | None:
        """The stored trace's Chrome JSON, or None if unknown/evicted."""
        with self._trace_lock:
            tr = self._traces.get(request_id)
        return tr.to_chrome() if tr is not None else None

    def note_stream(self, trace, t0: float, t1: float,
                    n_events: int) -> None:
        """Record the HTTP stream span and refresh the on-disk dump."""
        if trace is NULL_TRACE:
            return
        trace.add("stream", t0, t1, args={"events": n_events}, tid="http")
        self.dump_trace(trace)

    # -- flight recorder --------------------------------------------------

    def flight_start(self, request_id: str, summary: dict) -> None:
        """Open a flight entry (no-op when disabled)."""
        if self.config.enabled:
            self.flight.start(request_id, summary)

    def flight_record(self, request_id: str, event: str, **fields) -> None:
        """Append a flight event (no-op when disabled)."""
        if self.config.enabled:
            self.flight.record(request_id, event, **fields)

    def flight_finish(self, request_id: str, outcome: str) -> None:
        """Close a flight entry (no-op when disabled)."""
        if self.config.enabled:
            self.flight.finish(request_id, outcome)

    def debug_requests(self) -> dict:
        """Flight-recorder snapshot for ``GET /v1/debug/requests``."""
        snap = self.flight.snapshot()
        snap["enabled"] = self.config.enabled
        return snap

    # -- device profiling -------------------------------------------------

    @contextlib.contextmanager
    def profile_session(self, tag: str, device=None):
        """Wrap a rollout in ``torch.profiler`` tracing, if configured.

        Records CPU activity, and CUDA activity when ``device`` is a CUDA
        device, and exports a Chrome trace to
        ``<profile_dir>/<tag>.trace.json`` when the session ends.  Yields
        that path, or None when profiling is off, another session holds
        the (process-global) profiler, or startup failed -- the rollout
        itself never fails on profiler trouble.
        """
        d = self.config.profile_dir
        if not d:
            yield None
            return
        if not self._prof_lock.acquire(blocking=False):
            _log.warning("profiler busy; skipping profile for %s", tag)
            yield None
            return
        prof, path = None, os.path.join(d, f"{tag}.trace.json")
        try:
            try:
                import torch
                acts = [torch.profiler.ProfilerActivity.CPU]
                if device is not None and torch.device(device).type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                os.makedirs(d, exist_ok=True)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
                self.profiles.inc()
            except Exception as e:  # profiler trouble never fails requests
                _log.warning("torch.profiler start failed for %s: %s",
                             tag, e)
                prof = None
            yield path if prof is not None else None
        finally:
            if prof is not None:
                try:
                    prof.stop()
                    prof.export_chrome_trace(path)
                except Exception as e:
                    _log.warning("torch.profiler stop/export failed: %s", e)
            self._prof_lock.release()
