"""Async request scheduler: many forecast requests, few warm engines.

``ForecastScheduler`` turns ``ForecastEngine`` into a long-lived
service core:

* requests queue in FIFO order and are validated **before** queueing
  (``RequestSpec.validate`` -- a clear error instead of a mid-trace
  failure);
* device work is bounded by ``max_concurrency`` worker threads (torch
  releases the GIL in its kernels and launches are asynchronous on the
  card, so a small pool overlaps host work with device compute; each
  worker sets the scheduler's device, and workers sharing one model
  take turns at each chunk, since the bf16 policy swaps the shared
  module's parameters for its call);
* **coalescing**: with ``max_batch`` > 1 a worker batches the picked
  request with queued requests sharing its ``batch_key`` -- same
  warm engine, rollout length and score set -- waiting up to
  ``batch_window_ms`` for companions, and rolls all of them through
  **one** batched rollout (``ForecastEngine.stream_batched``: each
  request keeps its own member init, draws and scores; the products
  run at another batch size, so results match serial runs to the
  reference's dispatch bar, rtol 1e-4).  Each member keeps its own NDJSON
  stream, demuxed from the shared rollout; a member cancelled
  mid-batch is masked out of further events while the others finish;
* engines are warm per **shape key** -- the spec fields that select a
  different engine -- shared across requests, and LRU-evicted
  under ``engine_budget_bytes`` (``EnginePool``), so heavy multi-shape
  traffic cannot grow device memory without bound;
* keys are warmed through the ``ExecutableCache`` before the rollout
  starts (kernel libraries loaded, the engine's inputs resident),
  splitting every request's latency into the ``queue_s`` /
  ``compile_s`` / ``run_s`` it reports;
* results leave as transport events chunk-by-chunk
  (``ForecastStream``); the retired chunk's device->host score copy
  runs on a dedicated thread, on a stream of its own that waits on an
  event recorded on the compute stream when the chunk retired -- never
  a device-wide synchronize -- so the dispatch thread is already
  launching chunk k+1 while chunk k's scores download and encode;
* every request is **observable** (``repro_torch.serving.observability``):
  the scheduler's counters are registry instruments (``/v1/stats`` is
  a view over the same values ``/metrics`` exposes), each request gets
  a span tree (queue -> coalesce -> compile|aot_hit -> stage_h2d ->
  chunk[k] -> score_fetch -> encode; the reference's names: ``compile``
  is a key warm that missed, ``aot_hit`` a warm key) on monotonic
  clocks, lifecycle
  events land in the flight recorder, and ``spec.profile`` wraps the
  rollout in a ``torch.profiler`` session -- all of it free when
  disabled and bit-identical always.

The noise draws of a request come from ``request_noise(model, seed)``,
one module-level function, so that a test can replace it with the JAX
reference's draws (``InjectedNoise``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import itertools
import logging
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.configs import fcn3 as fcn3cfg
from repro_torch.core.fcn3 import FCN3
from repro_torch.data import era5_synthetic as dlib
from repro_torch.inference import (ForecastEngine,
                                   InitialConditionPerturbation)
from repro_torch.inference.engine import NoiseSource, members_noise
from repro_torch.inference.params import load_params
from repro_torch.runtime import resolve_device
from repro_torch.serving import transport
from repro_torch.serving.cache import ExecutableCache
from repro_torch.serving.faults import (CircuitBreaker, CircuitOpenError,
                                        HEALTH_STATES, NULL_FAULTS,
                                        ReplicaHealth, classify_error)
from repro_torch.serving.observability import (METRIC_PREFIX, NULL_TRACE,
                                               Observability,
                                               ObservabilityConfig)
from repro_torch.serving.spec import RequestSpec  # noqa: F401 -- re-export

_log = logging.getLogger("repro_torch.serving.scheduler")


class QueueFull(RuntimeError):
    """The scheduler's request queue is at capacity (HTTP 503)."""


class ReplayGone(RuntimeError):
    """A resume asked for events that aged out of the replay ring
    (or lie beyond the stream's terminal event) -- HTTP 410."""


_SHUTDOWN = object()  # _pick_locked's "a close sentinel was consumed"


def request_noise(model: FCN3, seed: int) -> NoiseSource:
    """The noise source of a request with ``seed``: the port's
    ``members_noise`` (the JAX scheduler's ``PRNGKey(seed)``)."""
    return members_noise(model, seed)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as host numpy; bf16 (the bf16 policy's state) widens to
    fp32, exactly, since numpy has no bf16."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _latency_stats(samples) -> dict:
    """p50/p95 of (queue_s, total_s) samples over the sliding window."""
    if not samples:
        return {"count": 0}
    qs = np.asarray([s[0] for s in samples], dtype=np.float64)
    ts = np.asarray([s[1] for s in samples], dtype=np.float64)
    return {"count": len(samples),
            "queue_s": {"p50": float(np.percentile(qs, 50)),
                        "p95": float(np.percentile(qs, 95))},
            "total_s": {"p50": float(np.percentile(ts, 50)),
                        "p95": float(np.percentile(ts, 95))}}


class KeyedBuilds:
    """Build-once-per-key registry with per-key build locks.

    The double-checked-locking implementation shared with the model
    pool (the executable cache's ``warm`` keeps its own variant -- its
    critical section has disk/compile branches, not a single build):
    lookups touch only the global lock, and a cold build for one key
    never blocks a hit -- or a build -- for another.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._items: dict = {}
        self._build_locks: dict = {}

    def get_or_build(self, key, build):
        """The item for ``key``, calling ``build()`` at most once."""
        with self._lock:
            item = self._items.get(key)
            if item is not None:
                return item
            build_lock = self._build_locks.setdefault(key, threading.Lock())
        with build_lock:
            with self._lock:
                item = self._items.get(key)
            if item is None:
                item = build()
                with self._lock:
                    self._items[key] = item
            return item

    def snapshot(self) -> dict:
        """A point-in-time copy of the built items."""
        with self._lock:
            return dict(self._items)


class EnginePool:
    """Warm engines per shape key, LRU-evicted under a byte budget.

    ``get_or_build`` keeps ``KeyedBuilds``' per-key build-lock semantics
    (a cold engine build for one shape never blocks a warm hit for
    another) and additionally touches the key for LRU ordering.
    ``enforce_budget`` evicts least-recently-used engines until the
    pool's ``ForecastEngine.estimated_bytes`` total fits
    ``budget_bytes``; the most recently used engine always survives (a
    budget smaller than one engine must still serve that engine).
    Eviction only drops the pool's reference -- an in-flight rollout on
    an evicted engine holds its own reference and finishes normally;
    the next request for that key rebuilds and re-warms, reported as an
    honest cache miss.  Build locks are **stable across eviction**:
    popping a key's lock while a builder holds it would let the next
    request mint a fresh lock and build the same engine twice
    concurrently.  A lock is a few hundred bytes against a GB-scale
    engine, so the registry never shrinks.
    """

    def __init__(self, budget_bytes: int | None = None):
        self.budget_bytes = budget_bytes
        self._lock = threading.Lock()
        self._engines: collections.OrderedDict = collections.OrderedDict()
        self._build_locks: dict = {}
        self._evictions = 0

    def get_or_build(self, key, build):
        """The engine for ``key`` (built at most once), LRU-touched."""
        with self._lock:
            eng = self._engines.get(key)
            if eng is not None:
                self._engines.move_to_end(key)
                return eng
            build_lock = self._build_locks.setdefault(key, threading.Lock())
        with build_lock:
            with self._lock:
                eng = self._engines.get(key)
                if eng is not None:
                    self._engines.move_to_end(key)
                    return eng
            eng = build()
            with self._lock:
                self._engines[key] = eng
                self._engines.move_to_end(key)
            return eng

    def enforce_budget(self) -> int:
        """Evict LRU engines until the pool fits the budget.  Returns
        how many were evicted by this call."""
        if self.budget_bytes is None:
            return 0
        evicted = 0
        with self._lock:
            # size every engine once; evictions subtract instead of
            # re-running the (memory-analysis-backed) estimate per turn
            sizes = {key: eng.estimated_bytes()
                     for key, eng in self._engines.items()}
            total = sum(sizes.values())
            while len(self._engines) > 1 and total > self.budget_bytes:
                key = next(iter(self._engines))  # least recently used
                total -= sizes[key]
                del self._engines[key]
                # NOT popping _build_locks[key]: a thread inside
                # get_or_build's critical section still holds that lock
                # object, and dropping the registry entry would hand the
                # next requester a fresh lock -- two concurrent builds
                # (and warms) of one engine.
                self._evictions += 1
                evicted += 1
        return evicted

    def snapshot(self) -> dict:
        """A point-in-time copy of the warm engines by shape key."""
        with self._lock:
            return dict(self._engines)

    def stats(self, engine_bytes: int | None = None) -> dict:
        """Pool statistics; pass ``engine_bytes`` when the caller has
        already sized the engines (the scheduler's stats() does, for its
        per-engine rows) to avoid re-running the estimates."""
        with self._lock:
            if engine_bytes is None:
                engine_bytes = sum(e.estimated_bytes()
                                   for e in self._engines.values())
            return {
                "engines": len(self._engines),
                "engine_bytes": engine_bytes,
                "engine_budget_bytes": self.budget_bytes,
                "evictions": self._evictions,
            }


@dataclasses.dataclass
class ModelBundle:
    """Everything per named config the engines share: the model (its
    parameters live in the module), the (synthetic-ERA5) data source and
    the geometry buffers.  ``lock`` serializes the engines that drive the
    model: an engine runs its model from one thread at a time."""

    name: str
    model: FCN3
    ds: dlib.SyntheticERA5
    buffers: dict
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)


def build_bundle(name: str, ckpt: str | None = None,
                 device: str | torch.device = "cuda") -> ModelBundle:
    """Deterministic bundle construction on ``device`` (calibrated on
    sample 0, or restored from ``ckpt``), so a direct ``ForecastEngine``
    on the same model reproduces served results bit for bit."""
    dev = resolve_device(device)
    cfg = fcn3cfg.NAMED_CONFIGS[name]()
    model = FCN3(cfg, device=dev)
    ds = dlib.SyntheticERA5(cfg, device=dev)
    buffers = model.make_buffers()
    load_params(model, ds, buffers, ds.state(0, 0), ckpt)
    return ModelBundle(name=name, model=model, ds=ds, buffers=buffers)


class ModelPool:
    """Per-config bundles on one device, built once and shared by all
    engines.

    Builds are serialized per config name, never under a global lock: a
    multi-minute "full" build must not stall a warm "smoke" request.
    The device is ``cuda`` unless the caller asks for ``"cpu"``.
    """

    def __init__(self, ckpts: dict[str, str] | None = None,
                 device: str | torch.device = "cuda"):
        self._ckpts = ckpts or {}
        self.device = resolve_device(device)
        self._bundles = KeyedBuilds()

    def get(self, name: str) -> ModelBundle:
        """The shared ``ModelBundle`` for a named config (built once)."""
        return self._bundles.get_or_build(
            name, lambda: build_bundle(name, self._ckpts.get(name),
                                       self.device))


class ForecastStream:
    """Handle for one submitted request: a blocking iterator of
    transport events, fed by the worker as chunks retire.

    QoS bookkeeping lives here too: ``deadline_at`` (absolute
    ``perf_counter`` deadline, or None), ``serve_spec`` (what the
    scheduler actually serves -- the submitted spec, unless the degrade
    policy latched a smaller member count), ``degraded_members`` (set
    iff degraded) and ``requeued`` (parked once to join the next batch
    of its shape instead of rolling solo).

    Fault tolerance turned the event queue into a bounded **replay
    ring**: events keep an implicit sequence number (their ordinal in
    the stream, starting at 0), the last ``replay_window`` of them stay
    buffered after delivery, and ``events(from_seq=...)`` replays from
    any still-buffered ordinal -- how ``GET /v1/stream/<id>?from=<seq>``
    resumes a severed connection with bytes identical to the unbroken
    stream.  ``started``/``next_chunk`` suppress duplicate events when
    the scheduler re-dispatches the rollout after a transient failure
    (``retries`` counts those); ``disconnected_at`` marks a consumer
    that dropped mid-stream and is still within the resume grace.
    """

    def __init__(self, request_id: str, spec: RequestSpec,
                 replay_window: int = 512):
        self.request_id = request_id
        self.spec = spec
        self.serve_spec = spec
        self.degraded_members: int | None = None
        self.requeued = False
        #: span tree for this request (NULL_TRACE when tracing is off)
        self.trace = NULL_TRACE
        #: when a worker took this stream off the queue (None: queued)
        self.picked_at: float | None = None
        self.submitted_at = time.perf_counter()
        self.deadline_at = (self.submitted_at + spec.deadline_ms / 1e3
                            if spec.deadline_ms is not None else None)
        # retry / resume bookkeeping (written by the worker / service)
        self.started = False
        self.next_chunk = 0
        self.retries = 0
        self.resumes = 0
        self.disconnected_at: float | None = None
        # the replay ring: events [_base, _base + len(_ring)) are
        # buffered; older ones aged out (ReplayGone on resume)
        self._capacity = max(8, int(replay_window))
        self._ring: collections.deque = collections.deque()
        self._base = 0
        self._terminal_seq: int | None = None
        self._ev_cond = threading.Condition()
        self._cancelled = threading.Event()
        self._terminal = False
        self._term_lock = threading.Lock()

    def put(self, ev: dict) -> None:
        """Append one transport event to the ring (called by the
        serving worker), waking any blocked ``events()`` iterators."""
        with self._ev_cond:
            self._ring.append(ev)
            if ev.get("event") in transport.TERMINAL_EVENTS:
                self._terminal_seq = self._base + len(self._ring) - 1
            while len(self._ring) > self._capacity:
                self._ring.popleft()
                self._base += 1
            self._ev_cond.notify_all()

    def claim_terminal(self) -> bool:
        """Claim the stream's one terminal event: the first caller wins
        (worker done/error, deadline shed, cancel-at-pickup and shutdown
        unblocking all funnel through here), later callers get False.
        The winner then enqueues it with ``put``, so that the stream
        never sees two terminals and ``events()``/``result()`` always
        unblock."""
        with self._term_lock:
            if self._terminal:
                return False
            self._terminal = True
        return True

    def cancel(self) -> None:
        """Consumer went away for good: a solo rollout stops at the next
        chunk boundary; a coalesced member is masked out of further
        chunk events while its batch companions finish."""
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        """Whether the consumer cancelled this stream."""
        return self._cancelled.is_set()

    @property
    def terminal(self) -> bool:
        """Whether a terminal event has been enqueued."""
        with self._term_lock:
            return self._terminal

    def seq_bounds(self) -> tuple[int, int, int | None]:
        """``(base, end, terminal_seq)``: the buffered ordinal range
        ``[base, end)`` and the terminal event's ordinal (or None)."""
        with self._ev_cond:
            return (self._base, self._base + len(self._ring),
                    self._terminal_seq)

    def events(self, from_seq: int = 0):
        """Yield transport events from ordinal ``from_seq`` until a
        terminal one (blocking).  Raises ``ReplayGone`` when the asked
        ordinal aged out of the ring or lies beyond the terminal."""
        i = max(0, int(from_seq))
        while True:
            with self._ev_cond:
                while True:
                    if (self._terminal_seq is not None
                            and i > self._terminal_seq):
                        raise ReplayGone(
                            f"stream {self.request_id} ended at seq "
                            f"{self._terminal_seq}; nothing at {i}")
                    if i < self._base:
                        raise ReplayGone(
                            f"events before seq {self._base} aged out of "
                            f"the replay ring (asked from {i})")
                    if i < self._base + len(self._ring):
                        break
                    self._ev_cond.wait()
                ev = self._ring[i - self._base]
            yield ev
            if ev.get("event") in transport.TERMINAL_EVENTS:
                return
            i += 1

    def result(self) -> transport.ServedForecast:
        """Block until done and fold the stream into arrays."""
        return transport.collect(self.events())


class ForecastScheduler:
    """Bounded worker pool over a QoS-aware queue of ``RequestSpec``s,
    with same-shape request coalescing and engine-pool memory budgeting.

    The pickup policy (the QoS tier on top of coalescing):

    * **priority then FIFO** -- "interactive" requests are picked before
      "batch" ones, FIFO within a class; a batch request that has waited
      ``aging_ms`` is promoted, so batch traffic cannot starve;
    * **deadline shed** -- a request whose ``deadline_ms`` expired while
      queued is dropped at pickup with a terminal ``error`` event
      (``reason: "deadline"``) instead of burning engine build, compile
      and a full rollout;
    * **graceful degradation** (opt-in via ``spec.degrade``) -- a
      near-deadline request is re-aimed at ``spec.degraded_members()``
      members (the validated floor) instead of missing; the served
      member count is reported honestly in start/done events.  "Near"
      means within ``degrade_margin_ms`` of the deadline, or within 25%
      of the total budget when the margin is None;
    * **batch re-forming** -- a coalescible straggler whose window ended
      solo while a batch of its shape key is in flight parks once and
      joins the *next* batch of that key instead of rolling alone;
    * **cancellation shrink** -- when members of an in-flight batch
      cancel, the remaining chunks roll only the surviving requests
      (``ForecastEngine.stream_batched(survivors=...)`` slices their
      carries; the port needs no smaller-batch program to be warm).

    None of this touches ``engine_key``/``batch_key``: QoS routes and
    sheds traffic, it never fragments the warm-engine cache, and a
    request served without shed/degrade is bit-identical to the pure
    FIFO scheduler.
    """

    def __init__(self, pool: ModelPool | None = None,
                 cache: ExecutableCache | None = None,
                 max_concurrency: int = 1, queue_size: int = 64,
                 max_batch: int = 1, batch_window_ms: float = 0.0,
                 engine_budget_bytes: int | None = None,
                 aging_ms: float = 2000.0,
                 degrade_margin_ms: float | None = None,
                 latency_window: int = 512,
                 observability: Observability | ObservabilityConfig
                 | None = None,
                 faults=None,
                 retry_backoff_ms: float = 50.0,
                 retry_backoff_max_ms: float = 2000.0,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 replay_window: int = 512,
                 resume_grace_s: float = 15.0,
                 supervise_interval_s: float = 0.2,
                 ready: bool = True):
        self.pool = pool if pool is not None else ModelPool()
        #: the device every worker thread sets: the pool's, with its index
        #: (``torch.cuda.set_device`` wants one)
        self.device = self.pool.device
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.cache = cache if cache is not None else ExecutableCache()
        self.max_batch = max(1, max_batch)
        self.batch_window_ms = max(0.0, batch_window_ms)
        self.aging_ms = max(0.0, aging_ms)
        self.degrade_margin_ms = degrade_margin_ms
        self._queue_size = queue_size
        # fault tolerance: the injector is NULL_FAULTS unless faults were
        # armed (--fault), so the instrumented points cost one no-op call
        # on the unarmed path; the cache shares the same injector
        self.faults = faults if faults is not None else NULL_FAULTS
        self.cache.bind_faults(self.faults)
        self.retry_backoff_ms = max(0.0, retry_backoff_ms)
        self.retry_backoff_max_ms = max(self.retry_backoff_ms,
                                        retry_backoff_max_ms)
        self.breaker_threshold = max(1, breaker_threshold)
        self.breaker_cooldown_s = max(0.0, breaker_cooldown_s)
        self.replay_window = max(8, replay_window)
        self.resume_grace_s = max(0.0, resume_grace_s)
        self._supervise_interval = max(0.05, supervise_interval_s)
        #: replica health state machine behind GET /readyz; constructed
        #: ready unless the launcher wants to gate on preload/warmup
        #: (ready=False + mark_ready())
        self.health = ReplicaHealth(ready=ready)
        # per-engine-key circuit breakers: (label, CircuitBreaker)
        self._breakers: dict = {}
        self._breaker_lock = threading.Lock()
        # the instrumentation hub: every counter below is a registry
        # instrument (/v1/stats reads them back; /metrics renders the
        # same registry), traces/flight events route through it too
        if isinstance(observability, Observability):
            self.obs = observability
        else:
            self.obs = Observability(observability)
        self.obs.metrics.register_collector(self._collect_metrics)
        self.cache.bind_metrics(self.obs.metrics)
        # pending requests + close sentinels (None), FIFO; guarded by
        # _cond's lock so coalescing workers can scoop matching streams
        # out of the middle (queue.Queue cannot express that)
        self._pending: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._engines = EnginePool(engine_budget_bytes)
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._closed = False
        self._drained = False
        # set the moment close() begins: retry backoffs wait on it so a
        # drain never sleeps out an exponential backoff, and the
        # supervisor loop uses it as its shutdown signal
        self._closing = threading.Event()
        # sliding per-class latency window: (queue_s, total_s) samples
        # (a windowed percentile estimate, not a counter -- it stays
        # outside the registry; the total_seconds histogram is the
        # unwindowed exposition-side view)
        self._latency = {p: collections.deque(maxlen=max(1, latency_window))
                         for p in ("interactive", "batch")}
        # streams submitted but not yet terminal -- what a timed-out
        # close() must unblock so no consumer hangs forever
        self._open: set = set()
        # request_id -> stream, retained past terminal (bounded) so
        # GET /v1/stream/<id>?from=<seq> can resume/replay recently
        # finished streams too; guarded by _lock
        self._by_id: collections.OrderedDict = collections.OrderedDict()
        self._by_id_capacity = max(2 * queue_size, 256)
        # in-flight coalesced batches per batch_key, for straggler
        # re-forming (guarded by _cond: pick decisions read it)
        self._inflight_keys: collections.Counter = collections.Counter()
        # warm-start provenance: set by WarmStartBundle.boot on a replica
        # booted from a bundle, surfaced as the "bundle" stats block
        self._bundle_info: dict | None = None
        self._crashes = 0
        self._worker_ids = itertools.count()
        self._workers = [
            threading.Thread(target=self._run_worker, daemon=True,
                             name=f"forecast-worker-{next(self._worker_ids)}")
            for _ in range(max(1, max_concurrency))]
        for w in self._workers:
            w.start()
        self._supervisor = threading.Thread(target=self._supervise,
                                            daemon=True,
                                            name="forecast-supervisor")
        self._supervisor.start()

    # ------------------------------------------------------------------
    def submit(self, spec: RequestSpec) -> ForecastStream:
        """Validate and enqueue; returns immediately with the stream."""
        t_admit = time.perf_counter()
        spec.validate()
        stream = ForecastStream(f"r{next(self._ids)}", spec,
                                replay_window=self.replay_window)
        # trace/flight entries attach BEFORE the stream is visible to a
        # worker (a pickup may race the tail of submit otherwise)
        if self.obs.enabled:
            stream.trace = self.obs.begin_trace(
                stream.request_id,
                {"config": spec.config, "members": spec.members,
                 "lead_steps": spec.lead_steps, "priority": spec.priority},
                t0=t_admit)
            stream.trace.add("admit", t_admit, time.perf_counter(),
                             args={"queue_size": self._queue_size})
            self.obs.flight_start(stream.request_id, {
                "config": spec.config, "members": spec.members,
                "lead_steps": spec.lead_steps, "priority": spec.priority,
                "deadline_ms": spec.deadline_ms, "degrade": spec.degrade,
                "profile": spec.profile})
            self.obs.flight_record(stream.request_id, "submitted")
        try:
            # closed-check and enqueue are one atomic step against
            # close(): a stream enqueued behind the shutdown sentinels
            # would never be popped and its consumer would block forever.
            with self._cond:
                if self._closed:
                    # distinct messages: mid-drain is "try again on
                    # another replica", fully closed is "this replica is
                    # gone" -- both map to HTTP 503 in service.py
                    raise RuntimeError(
                        "scheduler is closed" if self._drained else
                        "scheduler is draining; not accepting new requests")
                if sum(1 for s in self._pending
                       if s is not None) >= self._queue_size:
                    raise QueueFull(
                        f"request queue full ({self._queue_size} pending)")
                self._pending.append(stream)
                with self._lock:
                    self._open.add(stream)
                    self._by_id[stream.request_id] = stream
                    # retain recently finished streams for resume, but
                    # never evict one that is still open
                    while len(self._by_id) > self._by_id_capacity:
                        for rid, s in self._by_id.items():
                            if s not in self._open:
                                del self._by_id[rid]
                                break
                        else:
                            break
                self._cond.notify_all()
        except Exception:
            self.obs.flight_finish(stream.request_id, "rejected")
            self.obs.finish_trace(stream.trace)
            raise
        return stream

    def _finish(self, stream: ForecastStream, ev: dict) -> bool:
        """Push a terminal event (at most once per stream), retire the
        stream from the open-streams registry, and close its trace and
        flight entry with an honest outcome.

        The claim comes first, then the trace is closed (and dumped) and
        the outcome recorded, and only then is the terminal enqueued: a
        consumer whose ``result()`` returns finds the trace file on
        disk, and a second ``_finish`` neither dumps the trace again nor
        delivers a second terminal."""
        delivered = stream.claim_terminal()
        with self._lock:
            self._open.discard(stream)
        if not delivered:
            return False
        if self.obs.enabled:
            outcome = ev.get("event", "done")
            if outcome == "done" and ev.get("cancelled"):
                outcome = "cancelled"
            elif outcome == "error":
                outcome = ev.get("reason") or "error"
            try:
                self.obs.flight_finish(stream.request_id, outcome)
                self.obs.finish_trace(stream.trace)
            finally:
                stream.put(ev)
        else:
            stream.put(ev)
        return True

    def warmup(self, spec: RequestSpec, batch: int | None = None) -> dict:
        """Build the engine and warm its keys without running a rollout
        (the service CLI's --warm); ``batch`` warms the coalesced
        B-request keys instead."""
        spec.validate()
        engine, bundle = self._get_engine(spec)
        out = self.cache.warm_engine(spec.config, engine, spec.scored,
                                     spec.lead_steps, bundle.buffers,
                                     batch=batch)
        self._engines.enforce_budget()
        return out

    def engine_for(self, spec: RequestSpec) -> tuple:
        """The warm ``(ForecastEngine, ModelBundle)`` pair serving this
        spec's shape key (``RequestSpec.engine_key``), built on first
        use.  Public for introspection -- the warm-start bundle packer
        reads ``chunk_lengths``/``estimated_bytes``/``plan_exports``
        off the engine that ``warmup`` warmed."""
        return self._get_engine(spec)

    def set_bundle_info(self, info: dict) -> None:
        """Record warm-start-bundle provenance (bundle id, programs
        warmed, boot seconds); reported as the ``bundle`` stats block so
        ``/v1/stats`` proves where a replica's warm keys came from."""
        with self._lock:
            self._bundle_info = dict(info)

    @property
    def bundle_info(self) -> dict | None:
        """The ``set_bundle_info`` block, or None on a cold-booted
        (non-bundle) scheduler."""
        with self._lock:
            return (dict(self._bundle_info)
                    if self._bundle_info is not None else None)

    def trace_json(self, request_id: str) -> dict | None:
        """A served request's Chrome/Perfetto trace JSON (the
        ``GET /v1/trace/<id>`` payload), or None if unknown/evicted."""
        return self.obs.trace_json(request_id)

    def debug_requests(self) -> dict:
        """The flight-recorder snapshot (``GET /v1/debug/requests``)."""
        return self.obs.debug_requests()

    # -- fault tolerance: resume, health, breakers ----------------------
    def stream_by_id(self, request_id: str) -> ForecastStream | None:
        """The stream for a request id (open or recently finished), or
        None when unknown/aged out -- the ``GET /v1/stream/<id>``
        lookup."""
        with self._lock:
            return self._by_id.get(request_id)

    def note_disconnect(self, stream: ForecastStream) -> None:
        """The consumer's connection dropped mid-stream.  Instead of
        cancelling the rollout (the pre-fault-tolerance behavior), the
        stream enters a resume grace window: events keep accumulating
        in the replay ring, and a ``GET /v1/stream/<id>?from=<seq>``
        within ``resume_grace_s`` picks up bit-identically.  The
        supervisor cancels streams whose grace expires unclaimed."""
        if stream.terminal:
            return
        stream.disconnected_at = time.perf_counter()
        self.obs.stream_disconnects.inc()
        self.obs.flight_record(stream.request_id, "disconnected")
        _log.info("consumer of %s disconnected mid-stream; holding for "
                  "resume (%.1fs grace)", stream.request_id,
                  self.resume_grace_s)

    def note_resume(self, stream: ForecastStream, from_seq: int) -> None:
        """A consumer reattached via ``GET /v1/stream/<id>``: clear the
        grace clock and meter the resume."""
        stream.disconnected_at = None
        stream.resumes += 1
        self.obs.stream_resumes.inc()
        self.obs.flight_record(stream.request_id, "resumed",
                               from_seq=from_seq)

    def mark_ready(self) -> None:
        """Preload/warmup finished: flip the replica starting -> ready
        (the launcher calls this after ``--preload``/``--warm``)."""
        self.health.mark_ready()

    def _breaker_for(self, key) -> tuple[str, CircuitBreaker]:
        """The (label, breaker) pair for one engine key, created on
        first use.  The label -- ``config/sha1[:8]`` -- is what metrics,
        stats and shed errors name the key by."""
        with self._breaker_lock:
            ent = self._breakers.get(key)
            if ent is None:
                label = (f"{key[0]}/"
                         f"{hashlib.sha1(repr(key).encode()).hexdigest()[:8]}")
                ent = (label, CircuitBreaker(self.breaker_threshold,
                                             self.breaker_cooldown_s))
                self._breakers[key] = ent
            return ent

    def _breaker_snapshots(self) -> dict:
        """Per-key breaker snapshots keyed by label (stats block)."""
        with self._breaker_lock:
            ents = list(self._breakers.values())
        return {label: br.snapshot() for label, br in ents}

    def _collect_metrics(self) -> list[dict]:
        """Collector polled at ``/metrics`` scrape time: live values the
        scheduler does not tally itself -- queue depths, open streams,
        the engine pool, per-engine chunk counts and warm-start bundle
        provenance.  Reading at scrape time (the Prometheus
        custom-collector pattern) keeps these exactly equal to what
        ``stats()`` reports."""
        p = METRIC_PREFIX
        snap = self._engines.snapshot()
        dispatch: collections.Counter = collections.Counter()
        for eng in snap.values():
            for k, v in eng.dispatch_stats().items():
                dispatch[k] += v
        pool = self._engines.stats()
        with self._cond:
            depth = {"interactive": 0, "batch": 0}
            for s in self._pending:
                if s is not None:
                    depth[s.spec.priority] += 1
        with self._lock:
            open_n = len(self._open)
            binfo = (dict(self._bundle_info)
                     if self._bundle_info is not None else None)
        health_state = self.health.state
        out = [
            {"name": p + "queue_depth", "type": "gauge",
             "help": "Requests queued, by priority class",
             "samples": [({"priority": k}, v)
                         for k, v in sorted(depth.items())]},
            {"name": p + "open_streams", "type": "gauge",
             "help": "Streams submitted but not yet terminal",
             "samples": [({}, open_n)]},
            {"name": p + "engine_pool_engines", "type": "gauge",
             "help": "Warm engines in the pool",
             "samples": [({}, pool["engines"])]},
            {"name": p + "engine_pool_bytes", "type": "gauge",
             "help": "Estimated bytes held by warm engines",
             "samples": [({}, pool["engine_bytes"])]},
            {"name": p + "engine_pool_evictions_total", "type": "counter",
             "help": "Engines LRU-evicted under the byte budget",
             "samples": [({}, pool["evictions"])]},
            {"name": p + "engine_dispatch_total", "type": "counter",
             "help": "Chunks rolled and coalesced-rollout shrinks",
             "samples": [({"path": k}, dispatch.get(k, 0))
                         for k in ("chunks", "shrinks")]},
            {"name": p + "engine_h2d_chunks_total", "type": "counter",
             "help": "Host->device chunk stagings",
             "samples": [({}, dispatch.get("h2d_chunks", 0))]},
            {"name": p + "engine_h2d_steps_total", "type": "counter",
             "help": "Host->device staged (source, step) pairs",
             "samples": [({}, dispatch.get("h2d_steps", 0))]},
            {"name": p + "health_state", "type": "gauge",
             "help": "Replica health (1 on the current state's label)",
             "samples": [({"state": st}, 1 if st == health_state else 0)
                         for st in HEALTH_STATES]},
        ]
        fstats = self.faults.stats()
        if fstats["armed"]:
            out.append({
                "name": p + "faults_injected_total", "type": "counter",
                "help": "Injected faults fired, by point",
                "samples": [({"point": pt}, n) for pt, n
                            in sorted(fstats["fired"].items())] or
                           [({}, 0)]})
        breakers = self._breaker_snapshots()
        if breakers:
            code = {"closed": 0, "half_open": 1, "open": 2}
            out.append({
                "name": p + "circuit_state", "type": "gauge",
                "help": "Circuit breaker state per engine key "
                        "(0 closed, 1 half-open, 2 open)",
                "samples": [({"key": lbl}, code[s["state"]])
                            for lbl, s in sorted(breakers.items())]})
        if binfo is not None:
            bid = str(binfo.get("bundle_id", ""))[:12]
            out.append({
                "name": p + "bundle_boot_seconds", "type": "gauge",
                "help": "Warm-start bundle boot wall time",
                "samples": [({"bundle_id": bid},
                             float(binfo.get("boot_s", 0.0)))]})
            out.append({
                "name": p + "bundle_programs", "type": "gauge",
                "help": "Keys pre-warmed from the bundle",
                "samples": [({"bundle_id": bid},
                             binfo.get("programs", 0))]})
        return out

    @staticmethod
    def _by_label(counter) -> dict:
        """A single-label registry counter as ``{label_value: int}`` --
        the exact shape the pre-registry QoS dicts had."""
        return {k[0]: int(v) for k, v in sorted(counter.values().items())}

    def stats(self) -> dict:
        """The ``/v1/stats`` payload: queue/served/failed counters, the
        coalesced-batch histogram, per-engine rows with dispatch counts,
        pool and cache statistics, and the ``bundle`` provenance block
        (None unless the replica booted from a warm-start bundle).

        Every counter here is read back from the metrics registry --
        ``/v1/stats`` and ``/metrics`` are two renderings of one store,
        so they cannot disagree at quiescence."""
        snap = self._engines.snapshot()
        sizes = {key: eng.estimated_bytes() for key, eng in snap.items()}
        engines = [{"config": key[0],
                    "members": key[1].members,
                    "lead_chunk": key[1].lead_chunk,
                    "precision": key[1].compute_dtype,
                    "perturb": key[1].perturb.kind,
                    "kernels": (dataclasses.asdict(key[1].kernels)
                                if key[1].kernels is not None
                                else "inherit"),
                    "estimated_bytes": sizes[key],
                    "dispatch": eng.dispatch_stats()}
                   for key, eng in snap.items()]
        served = int(self.obs.served.value())
        failed = int(self.obs.failed.value())
        batches = {k[0]: int(v) for k, v in sorted(
            self.obs.batches.values().items(), key=lambda kv: int(kv[0][0]))}
        with self._lock:
            bundle_info = (dict(self._bundle_info)
                           if self._bundle_info is not None else None)
            qos = {
                "shed": self._by_label(self.obs.shed),
                "degraded": self._by_label(self.obs.degraded),
                "requeued": self._by_label(self.obs.requeued),
                "cancelled_queued": self._by_label(
                    self.obs.cancelled_queued),
                "batch_shrinks": int(self.obs.batch_shrinks.value()),
                "aging_ms": self.aging_ms,
                "degrade_margin_ms": self.degrade_margin_ms,
                "latency": {p: _latency_stats(d)
                            for p, d in self._latency.items()},
            }
        with self._cond:
            queued = sum(1 for s in self._pending if s is not None)
            depth = {"interactive": 0, "batch": 0}
            for s in self._pending:
                if s is not None:
                    depth[s.spec.priority] += 1
        qos["queue_depth"] = depth
        fault_tolerance = {
            "retries": int(self.obs.retries.value()),
            "worker_restarts": int(self.obs.worker_restarts.value()),
            "circuit_open_shed": int(self.obs.circuit_open_shed.value()),
            "stream_disconnects": int(
                self.obs.stream_disconnects.value()),
            "stream_resumes": int(self.obs.stream_resumes.value()),
            "faults": self.faults.stats(),
            "breakers": self._breaker_snapshots(),
            "health": self.health.snapshot(),
        }
        return {"queued": queued, "served": served,
                "failed": failed, "workers": len(self._workers),
                "max_batch": self.max_batch,
                "batch_window_ms": self.batch_window_ms,
                "batches": batches,
                "qos": qos,
                "fault_tolerance": fault_tolerance,
                "engines": engines,
                "pool": self._engines.stats(
                    engine_bytes=sum(sizes.values())),
                "cache": self.cache.stats(),
                "bundle": bundle_info}

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting requests, drain pending ones, join workers.

        On a drain timeout every still-open stream gets a terminal
        ``error`` event (``reason: "shutdown"``) so blocked
        ``events()``/``result()`` consumers always unblock -- a stuck
        worker must never strand its clients."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            # interrupt in-flight retry backoffs (drain must win over a
            # backoff sleep) and stop the supervisor loop
            self._closing.set()
            self.health.mark_draining()
            # sentinels go behind any already-queued streams, so pending
            # requests are served before the workers exit
            for _ in self._workers:
                self._pending.append(None)
            self._cond.notify_all()
        for w in self._workers:
            w.join(timeout=timeout)
        self._supervisor.join(timeout=timeout)
        stuck = [w.name for w in self._workers if w.is_alive()]
        if stuck:
            # daemon threads die with the process; say so -- and unblock
            # every consumer still waiting on a terminal event
            _log.warning(
                "close() timed out after %ss with %d worker(s) still "
                "running (%s); terminating open streams with a shutdown "
                "error", timeout, len(stuck), stuck)
            with self._lock:
                open_streams = list(self._open)
            for s in open_streams:
                self._finish(s, {
                    "event": "error", "request_id": s.request_id,
                    "reason": "shutdown",
                    "message": (f"scheduler close() timed out after "
                                f"{timeout}s; stream terminated before "
                                f"completion")})
        with self._cond:
            self._drained = True

    # ------------------------------------------------------------------
    def _get_engine(self, spec: RequestSpec
                    ) -> tuple[ForecastEngine, ModelBundle]:
        """Warm engine for the spec's shape key, built on first use and
        LRU-touched on every hit (per-key build locks via EnginePool: a
        cold engine build for one shape never blocks warm requests or
        the stats endpoint).  A readonly cache refuses a config whose
        geometry plans the bundle did not install before anything is
        built."""
        self.cache.require_plans(spec.config)
        bundle = self.pool.get(spec.config)

        def build() -> ForecastEngine:
            self.faults.fire("engine_build", config=spec.config)
            pcfg = spec.perturbation_config()
            pert = (InitialConditionPerturbation.from_dataset(
                bundle.model.in_sht, pcfg, bundle.ds)
                if pcfg.active else None)
            return ForecastEngine(bundle.model, spec.engine_config(),
                                  perturbation=pert)

        return self._engines.get_or_build(spec.engine_key(), build), bundle

    def _take_matching(self, batch: list[ForecastStream], key) -> None:
        """Move queued streams sharing ``key`` into ``batch`` (caller
        holds ``_cond``; close sentinels, cancelled streams and
        non-matching streams keep their queue positions).  Parked
        (re-queued) stragglers of the same key ARE takeable -- joining
        the next batch of their shape is exactly why they parked."""
        matching = [s for s in self._pending
                    if s is not None and s.spec.coalesce
                    and not s.cancelled
                    and s.serve_spec.batch_key() == key]
        for s in matching[:self.max_batch - len(batch)]:
            self._pending.remove(s)
            s.picked_at = time.perf_counter()
            batch.append(s)

    # -- QoS admission control (all helpers assume _cond is held) ------
    def _drop_cancelled_locked(self, s: ForecastStream) -> None:
        """A consumer that went away while queued gets
        a terminal done (cancelled, zero chunks) and **no rollout**."""
        self.obs.cancelled_queued.inc(priority=s.spec.priority)
        self.obs.flight_record(s.request_id, "cancelled_queued")
        self._finish(s, {"event": "done", "request_id": s.request_id,
                         "cancelled": True})

    def _shed_locked(self, s: ForecastStream) -> None:
        """Deadline expired before pickup: terminal error with a
        machine-readable reason, zero engine/compile/rollout work."""
        self.obs.shed.inc(priority=s.spec.priority)
        self.obs.flight_record(
            s.request_id, "shed",
            waited_ms=round((time.perf_counter() - s.submitted_at) * 1e3, 1))
        self._finish(s, {
            "event": "error", "request_id": s.request_id,
            "reason": "deadline", "priority": s.spec.priority,
            "message": (f"deadline_ms={s.spec.deadline_ms} expired "
                        f"after {(time.perf_counter() - s.submitted_at) * 1e3:.0f}ms "
                        f"in queue; request shed before rollout")})

    def _degrade_at(self, s: ForecastStream) -> float | None:
        """Absolute time at which the degrade policy latches for this
        stream, or None when it never will."""
        if not (s.spec.degrade and s.deadline_at is not None):
            return None
        if self.degrade_margin_ms is not None:
            return s.deadline_at - self.degrade_margin_ms / 1e3
        return s.deadline_at - 0.25 * (s.spec.deadline_ms / 1e3)

    def _sweep_locked(self) -> None:
        """Apply admission control to the queue: drop cancelled streams,
        shed expired deadlines, latch degrades near deadlines."""
        now = time.perf_counter()
        for s in list(self._pending):
            if s is None:
                continue
            if s.cancelled:
                self._pending.remove(s)
                self._drop_cancelled_locked(s)
                continue
            if s.deadline_at is not None and now >= s.deadline_at:
                self._pending.remove(s)
                self._shed_locked(s)
                continue
            da = self._degrade_at(s)
            if (da is not None and s.degraded_members is None
                    and now >= da):
                dm = s.spec.degraded_members()
                if dm < s.spec.members:
                    s.degraded_members = dm
                    s.serve_spec = dataclasses.replace(s.spec, members=dm)
                    self.obs.degraded.inc(priority=s.spec.priority)
                    self.obs.flight_record(s.request_id, "degraded",
                                           members=dm)

    def _pick_locked(self):
        """Priority-then-FIFO pick with aging.  Class 0 is interactive
        plus any batch request that has waited >= ``aging_ms`` (so batch
        traffic cannot starve); FIFO within a class.  Parked stragglers
        stay skipped while a batch of their shape is in flight.  Returns
        a stream, ``_SHUTDOWN`` (a close sentinel was consumed), or None
        (nothing pickable right now)."""
        now = time.perf_counter()
        best, best_class = None, None
        has_stream = False
        for s in self._pending:
            if s is None:
                continue
            has_stream = True
            if (s.requeued and not self._closed
                    and self._inflight_keys[s.serve_spec.batch_key()] > 0):
                continue  # parked: the next batch of its key scoops it
            aged = (now - s.submitted_at) * 1e3 >= self.aging_ms
            cls = 0 if (s.spec.priority == "interactive" or aged) else 1
            if best is None or cls < best_class:
                best, best_class = s, cls
                if cls == 0:
                    break  # first class-0 in FIFO order wins outright
        if best is not None:
            self._pending.remove(best)
            best.picked_at = time.perf_counter()
            return best
        if not has_stream and self._pending:
            self._pending.popleft()  # consume one close sentinel
            return _SHUTDOWN
        return None

    def _next_wake_locked(self) -> float | None:
        """Seconds until the earliest queued deadline/degrade threshold
        (so sweeps run on time without busy-waiting), or None."""
        now = time.perf_counter()
        wake = None
        for s in self._pending:
            if s is None:
                continue
            for t in (s.deadline_at,
                      (self._degrade_at(s)
                       if s.degraded_members is None else None)):
                if t is not None:
                    dt = max(0.0, t - now)
                    wake = dt if wake is None else min(wake, dt)
        return wake

    def _next_batch(self) -> tuple[list[ForecastStream], object] | None:
        """Block for the next serveable request; coalesce queued
        same-shape requests behind it (waiting up to ``batch_window_ms``
        for the batch to fill).  Returns ``(batch, batch_key)`` with the
        key's in-flight count already incremented (the worker must
        decrement it), or None on shutdown."""
        with self._cond:
            while True:
                head = None
                while head is None:
                    self._sweep_locked()
                    head = self._pick_locked()
                    if head is _SHUTDOWN:
                        return None
                    if head is None:
                        self._cond.wait(timeout=self._next_wake_locked())
                batch = [head]
                key = head.serve_spec.batch_key()
                if self.max_batch > 1 and head.spec.coalesce:
                    self._take_matching(batch, key)
                    deadline = time.monotonic() + self.batch_window_ms / 1e3
                    while len(batch) < self.max_batch:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(timeout=remaining)
                        self._sweep_locked()
                        self._take_matching(batch, key)
                    # batch re-forming: a solo straggler of a shape with
                    # a batch already in flight parks once and joins the
                    # *next* batch of that key instead of rolling alone
                    if (len(batch) == 1 and not head.requeued
                            and not head.cancelled
                            and head.spec.deadline_ms is None
                            and not self._closed
                            and self._inflight_keys[key] > 0):
                        head.requeued = True
                        self.obs.requeued.inc(priority=head.spec.priority)
                        self.obs.flight_record(head.request_id, "requeued")
                        self._pending.append(head)
                        continue
                # final admission check: the window may have outlived a
                # member's consumer or deadline
                now = time.perf_counter()
                kept = []
                for s in batch:
                    if s.cancelled:
                        self._drop_cancelled_locked(s)
                    elif s.deadline_at is not None and now >= s.deadline_at:
                        self._shed_locked(s)
                    else:
                        kept.append(s)
                if not kept:
                    continue
                self._inflight_keys[key] += 1
                return kept, key

    def _worker(self) -> None:
        while True:
            # the worker fault point sits OUTSIDE any batch pickup: a
            # crash here (like a real bug in the pickup path) kills the
            # thread while it holds no requests, which is exactly the
            # silent-capacity-loss failure the supervisor exists for
            self.faults.fire("worker",
                             thread=threading.current_thread().name)
            item = self._next_batch()
            if item is None:
                return
            batch, key = item
            try:
                self._dispatch(batch)
            finally:
                with self._cond:
                    self._inflight_keys[key] -= 1
                    if self._inflight_keys[key] <= 0:
                        del self._inflight_keys[key]
                    # parked stragglers of this key become pickable
                    self._cond.notify_all()

    def _fail(self, stream: ForecastStream, e: Exception,
              kind: str | None = None, reason: str | None = None) -> None:
        """Terminal error (or cancelled-done) for one stream after a
        dispatch failure, with flight/metric bookkeeping."""
        self.obs.failed.inc()
        if stream.cancelled:
            # the consumer is gone; an error event would be noise
            self._finish(stream, {"event": "done",
                                  "request_id": stream.request_id,
                                  "cancelled": True})
            return
        msg = f"{type(e).__name__}: {e}"
        if stream.retries:
            msg += f" (after {stream.retries} retries)"
        ev = {"event": "error", "request_id": stream.request_id,
              "message": msg}
        if reason:
            ev["reason"] = reason
        if kind:
            ev["classification"] = kind
        if stream.retries:
            ev["retries"] = stream.retries
        self.obs.flight_record(stream.request_id, "error", message=msg)
        self._finish(stream, ev)

    def _dispatch(self, batch: list[ForecastStream]) -> None:
        """Serve one picked batch with per-request retry.

        Failures are classified (``faults.classify_error``): permanent
        ones fail every member immediately; transient ones re-dispatch
        the members with retry budget left (``spec.max_retries``) after
        a bounded exponential backoff, failing the rest.  The backoff
        waits on the closing event, so ``close()`` always wins the race
        against a sleeping retry -- the request then gets a terminal
        shutdown error instead of stalling the drain.  Re-dispatch is
        deterministic and duplicate-suppressed (``stream.started`` /
        ``stream.next_chunk``), so a retried request's event bytes are
        identical to a never-faulted run's."""
        attempt = 0
        while True:
            try:
                self._serve_batch(batch)
                self.obs.served.inc(len(batch))
                return
            except CircuitOpenError as e:
                # shed fast, never retried: the breaker exists to stop
                # work on this key until the cooldown probe says otherwise
                self.obs.circuit_open_shed.inc(len(batch))
                _log.warning("shed %s: %s",
                             [s.request_id for s in batch], e)
                for stream in batch:
                    self._fail(stream, e, reason="circuit_open")
                return
            except Exception as e:  # noqa: BLE001 -- keep serving
                attempt += 1
                kind = classify_error(e)
                retry = [s for s in batch
                         if kind == "transient" and not s.cancelled
                         and attempt <= s.spec.max_retries]
                _log.warning(
                    "dispatch failed for %s (%s, attempt %d): %s: %s",
                    [s.request_id for s in batch], kind, attempt,
                    type(e).__name__, e)
                for stream in batch:
                    if stream not in retry:
                        self._fail(stream, e, kind=kind)
                if not retry:
                    return
                delay = min(self.retry_backoff_max_ms,
                            self.retry_backoff_ms * 2 ** (attempt - 1)) / 1e3
                for stream in retry:
                    stream.retries = attempt
                    self.obs.flight_record(stream.request_id, "retrying",
                                           attempt=attempt,
                                           backoff_ms=round(delay * 1e3, 1))
                self.obs.retries.inc(len(retry))
                if self._closing.wait(delay):
                    # drain wins: terminal shutdown error, no silent hang
                    for stream in retry:
                        self.obs.failed.inc()
                        self._finish(stream, {
                            "event": "error",
                            "request_id": stream.request_id,
                            "reason": "shutdown",
                            "message": (f"scheduler closing; retry "
                                        f"{attempt} abandoned after "
                                        f"{type(e).__name__}: {e}")})
                    return
                batch = retry

    def _run_worker(self) -> None:
        """Worker thread body: the serve loop plus the crash net.  A
        worker dying outside the per-batch handling used to silently
        shrink capacity forever; now the crash is logged, health flips
        degraded, and the supervisor restarts the thread.  The current
        CUDA device is per thread: the worker sets the scheduler's."""
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._worker()
        except BaseException as e:  # noqa: BLE001 -- thread crash net
            if self._closing.is_set():
                return
            _log.error("worker %s crashed: %s: %s",
                       threading.current_thread().name,
                       type(e).__name__, e)
            with self._lock:
                self._crashes += 1
                crashes = self._crashes
            self.health.set_dead_workers(crashes - int(
                self.obs.worker_restarts.value()))

    def _supervise(self) -> None:
        """Supervisor loop: restart crashed worker threads (restoring
        serve capacity and flipping health back from degraded) and
        cancel disconnected streams whose resume grace expired.  Runs
        every ``supervise_interval_s`` until close() begins."""
        while not self._closing.wait(self._supervise_interval):
            # restart crashed workers (a dead thread before closing can
            # only be a crash: clean exits happen after close sentinels)
            restarted = 0
            for i, w in enumerate(self._workers):
                if not w.is_alive() and not self._closing.is_set():
                    nw = threading.Thread(
                        target=self._run_worker, daemon=True,
                        name=f"forecast-worker-{next(self._worker_ids)}")
                    self._workers[i] = nw
                    nw.start()
                    restarted += 1
            if restarted:
                self.obs.worker_restarts.inc(restarted)
                _log.warning("supervisor restarted %d crashed worker "
                             "thread(s)", restarted)
                self.health.set_dead_workers(
                    sum(1 for w in self._workers if not w.is_alive()))
            # sweep disconnected streams past their resume grace
            if self.resume_grace_s >= 0:
                now = time.perf_counter()
                with self._lock:
                    open_streams = list(self._open)
                for s in open_streams:
                    if (s.disconnected_at is not None and not s.terminal
                            and now - s.disconnected_at
                            > self.resume_grace_s):
                        s.disconnected_at = None
                        self.obs.flight_record(s.request_id,
                                               "resume_grace_expired")
                        _log.info("resume grace expired for %s; "
                                  "cancelling", s.request_id)
                        s.cancel()

    def _serve_batch(self, streams: list[ForecastStream]) -> None:
        """Serve one coalesced batch (possibly of size 1) through a
        single rollout, demuxing per-request events onto each stream.
        Runs each stream's ``serve_spec`` -- identical to the submitted
        spec unless the degrade policy latched a smaller member count,
        which start/done events then report as ``degraded_members``.

        Observability here is clock-reads and value-copies only: with
        tracing disabled (``traced`` False and ``on_span`` None) the
        dispatch path is structurally the pre-observability one, and a
        traced request launches the same kernels in the same order
        -- bit-identical either way."""
        spec = streams[0].serve_spec
        b = len(streams)
        t_start = time.perf_counter()
        traced = any(s.trace is not NULL_TRACE for s in streams)
        for stream in streams:
            picked = stream.picked_at or t_start
            stream.trace.add("queue", stream.submitted_at, picked,
                             args={"priority": stream.spec.priority})
            stream.trace.add("coalesce", picked, t_start,
                             args={"batch_size": b})
            self.obs.flight_record(stream.request_id, "picked",
                                   batch_size=b)
        # circuit breaker: a key whose builds/compiles keep failing is
        # shed here, before any engine or warm-up work -- the whole
        # point is not burning build time on a poisoned key
        key = spec.engine_key()
        label, breaker = self._breaker_for(key)
        if not breaker.allow():
            snap = breaker.snapshot()
            raise CircuitOpenError(
                f"circuit for engine key {label} is open after "
                f"{snap['consecutive_failures']} consecutive "
                f"build/compile failures; cooldown "
                f"{snap.get('cooldown_remaining_s', 0.0)}s remaining")
        # setup_s is everything between worker pickup and rollout start
        # that is NOT compilation proper: model-bundle / engine builds on
        # a cold config and time spent waiting on another request's
        # in-flight compile of the same key.  Without it, cold-request
        # latency would be silently misattributed (total_s != the sum of
        # its parts).
        try:
            engine, bundle = self._get_engine(spec)
            t_engine = time.perf_counter()
            warm = self.cache.warm_engine(spec.config, engine, spec.scored,
                                          spec.lead_steps, bundle.buffers,
                                          batch=b if b > 1 else None)
        except Exception:
            # only build/compile-phase failures count toward the
            # breaker: a mid-rollout fault says nothing about the key
            if breaker.record_failure():
                _log.error("circuit OPENED for engine key %s", label)
                self.health.set_breaker(label, True)
            raise
        if breaker.record_success():
            _log.info("circuit closed for engine key %s", label)
        self.health.set_breaker(label, False)
        t_warm = time.perf_counter()
        for stream in streams:
            stream.trace.add("engine_build", t_start, t_engine)
            stream.trace.add(
                "compile" if warm["misses"] else "aot_hit", t_engine,
                t_warm, args={"compile_s": warm["compile_s"],
                              "hits": warm["hits"],
                              "misses": warm["misses"]})
        # warming may have made new tensors resident: re-check the pool
        # budget now, so cold shapes evict cold engines, not the tests
        self._engines.enforce_budget()
        self.obs.batches.inc(size=str(b))
        setup_s = (time.perf_counter() - t_start) - warm["compile_s"]
        for i, stream in enumerate(streams):
            if stream.started:
                continue  # retry re-dispatch: the start event already went
            start = {"event": "start", "request_id": stream.request_id,
                     "spec": stream.spec.to_dict(),
                     "queue_s": t_start - stream.submitted_at,
                     "setup_s": setup_s,
                     "compile_s": warm["compile_s"],
                     "batch_size": b, "batch_index": i,
                     "cache": warm["outcomes"]}
            if stream.degraded_members is not None:
                # honest reporting: the consumer learns up front it is
                # getting fewer members than it asked for
                start["degraded_members"] = stream.degraded_members
            stream.started = True
            stream.put(start)
        ds = bundle.ds
        state0s = [ds.state(s.serve_spec.sample, 0) for s in streams]
        noises = [request_noise(bundle.model, s.serve_spec.seed)
                  for s in streams]
        # one shared aux source (and one truth source per distinct
        # sample): the batched stager stages each distinct source once
        # and broadcasts device-side, so B coalesced members cost one
        # aux staging, not B identical ones
        def _staged(fn):
            # h2d_stage fault point: the stager propagates staging
            # exceptions through fut.result(), exactly like a real host
            # failure materializing a step
            def wrapped(n):
                self.faults.fire("h2d_stage", step=n)
                return fn(n)
            return wrapped

        aux = (lambda n: ds.aux_fields(6.0 * (n + 1)))
        if self.faults is not NULL_FAULTS:
            # wrap only when armed: the unarmed path hands the engine
            # the exact pre-fault-tolerance stage callables (and keeps
            # the batched stager's dedup-by-identity intact)
            aux = _staged(aux)
        auxs = [aux] * b
        truths = None
        if spec.scored:
            by_sample = {s.spec.sample: (lambda sm: (
                lambda n: ds.state(sm, n + 1)))(s.spec.sample)
                for s in streams}
            if self.faults is not NULL_FAULTS:
                by_sample = {k: _staged(v) for k, v in by_sample.items()}
            truths = [by_sample[s.spec.sample] for s in streams]
        # stage_h2d spans: the stager's background thread reports each
        # chunk's host materialization through this clock-only hook
        # (None when observability is off -- the engine then runs the
        # exact pre-observability stage functions)
        on_span = None
        if self.obs.enabled:
            def on_span(name, s_t0, s_t1, args=None):
                self.obs.h2d_seconds.observe(s_t1 - s_t0)
                for st in streams:
                    st.trace.add(name, s_t0, s_t1, args=args)

        # opt-in device profiling: process-global, so at most one
        # session at a time (the hub's lock arbitrates); never enters
        # engine_key/batch_key and never fails the request
        prof_ids = [s.request_id for s in streams if s.serve_spec.profile]
        prof_cm = (self.obs.profile_session("_".join(prof_ids),
                                            self.device)
                   if prof_ids and self.obs.config.profile_dir
                   else contextlib.nullcontext(None))
        run_t0 = time.perf_counter()
        if b == 1:
            blocks = ([blk] for blk in engine.stream(
                bundle.buffers, state0s[0], auxs[0], noises[0],
                steps=spec.lead_steps,
                truth=truths[0] if truths is not None else None,
                on_span=on_span))
        else:
            # cancellation-aware shrink: the engine polls the surviving
            # (non-cancelled) request indices at every chunk boundary and
            # rolls only those from then on
            blocks = engine.stream_batched(
                bundle.buffers, state0s, auxs, noises,
                steps=spec.lead_steps, truths=truths,
                survivors=lambda: [j for j, st in enumerate(streams)
                                   if not st.cancelled],
                on_span=on_span)
        # the scores' device->host copies run on a stream of their own,
        # each after an event recorded on the compute stream when its
        # chunk retired (None on the CPU)
        cuda = self.device.type == "cuda"
        fetch_stream = torch.cuda.Stream(self.device) if cuda else None

        chunk_s: list[list[float]] = [[] for _ in streams]
        finals: list = [None] * b
        last_ready = [run_t0]
        shrunk = [False]
        rollout_sids: dict[str, int] = {}
        if traced:
            for stream in streams:
                stream.trace.add("inputs", t_warm, run_t0,
                                 args={"batch_size": b})
                rollout_sids[stream.request_id] = stream.trace.begin(
                    "rollout", args={"batch_size": b})

        def fetch_and_emit(index: int, block_list, retired) -> None:
            # Runs on the dedicated fetch thread, in chunk order: the
            # device->host score copy happens here, on the fetch stream
            # after the chunk's ``retired`` event, so the dispatch thread
            # is already launching chunk k+1 while chunk k's scores
            # download (score_fetch) and encode.
            self.faults.fire("score_fetch", index=index)
            f0 = time.perf_counter() if traced else 0.0
            if cuda:
                torch.cuda.set_device(self.device)
                fetch_stream.wait_event(retired)
            with (torch.cuda.stream(fetch_stream) if cuda
                  else contextlib.nullcontext()):
                host_blocks = fetch(block_list)
            f1 = time.perf_counter() if traced else 0.0
            emit(index, host_blocks, f0, f1)

        def fetch(block_list) -> list:
            host_blocks: list = [None] * len(block_list)
            for j, (stream, blk) in enumerate(zip(streams, block_list)):
                if stream.cancelled or blk is None:
                    # blk is None exactly when the rollout shrank away
                    # from this (cancelled) member's slot
                    if blk is None and not shrunk[0]:
                        shrunk[0] = True
                        self.obs.batch_shrinks.inc()
                        for st in streams:
                            self.obs.flight_record(st.request_id,
                                                   "shrink", index=index)
                    continue
                # materialize the scores on host NOW (chunk_event's
                # np.asarray is then a no-op view)
                host_scores = {k: _host(v) for k, v in blk.scores.items()}
                if blk.final_state is not None and stream.spec.return_state:
                    finals[j] = _host(blk.final_state)
                host_blocks[j] = types.SimpleNamespace(
                    lead_steps=blk.lead_steps, scores=host_scores)
            return host_blocks

        def emit(index: int, host_blocks, f0: float, f1: float) -> None:
            evs = []
            for j, (stream, blk) in enumerate(zip(streams, host_blocks)):
                if blk is None:
                    continue
                evs.append((j, stream,
                            transport.chunk_event(stream.request_id,
                                                  index, blk)))
            now = time.perf_counter()
            dt = now - last_ready[0]
            last_ready[0] = now
            for j, stream, ev in evs:
                ev["chunk_s"] = dt
                chunk_s[j].append(dt)
                if index < stream.next_chunk:
                    continue  # retry re-dispatch: this chunk already went
                stream.next_chunk = index + 1
                stream.put(ev)
            if traced:
                for j, stream, ev in evs:
                    parent = rollout_sids.get(stream.request_id, 0)
                    stream.trace.add("score_fetch", f0, f1, parent=parent,
                                     args={"index": index})
                    stream.trace.add("encode", f1, now, parent=parent,
                                     args={"index": index})

        futures = []
        with prof_cm as prof_path:
            with ThreadPoolExecutor(max_workers=1,
                                    thread_name_prefix="d2h-fetch") as ex:
                block_iter = enumerate(blocks)
                while True:
                    c0 = time.perf_counter() if traced else 0.0
                    try:
                        # one chunk's launches; engines on one model take
                        # turns (the bf16 policy swaps its parameters)
                        with bundle.lock:
                            index, block_list = next(block_iter)
                    except StopIteration:
                        break
                    retired = None
                    if cuda:
                        retired = torch.cuda.Event()
                        retired.record(torch.cuda.current_stream(
                            self.device))
                    self.faults.fire("rollout_chunk", index=index)
                    if traced:
                        c1 = time.perf_counter()
                        for stream in streams:
                            stream.trace.add(
                                f"chunk[{index}]", c0, c1,
                                parent=rollout_sids.get(stream.request_id,
                                                        0),
                                args={"index": index})
                    futures.append(ex.submit(fetch_and_emit, index,
                                             block_list, retired))
                    if all(s.cancelled for s in streams):
                        break
                for f in futures:
                    f.result()  # propagate fetch/encode failures
        run_s = time.perf_counter() - run_t0
        if traced:
            for stream in streams:
                end_args = {"run_s": run_s}
                if prof_path:
                    end_args["profile_trace"] = prof_path
                stream.trace.end(rollout_sids[stream.request_id],
                                 args=end_args)
        for j, stream in enumerate(streams):
            d0 = time.perf_counter() if traced else 0.0
            queue_s = t_start - stream.submitted_at
            total_s = time.perf_counter() - stream.submitted_at
            done = {
                "event": "done", "request_id": stream.request_id,
                "cancelled": stream.cancelled,
                "timing": {"queue_s": queue_s,
                           "setup_s": setup_s,
                           "compile_s": warm["compile_s"],
                           "run_s": run_s,
                           "total_s": total_s,
                           "batch_size": b,
                           "chunk_s": chunk_s[j]},
                "cache": {"hits": warm["hits"], "misses": warm["misses"]},
            }
            if prof_path:
                done["profile"] = prof_path
            if stream.degraded_members is not None:
                done["degraded_members"] = stream.degraded_members
            if stream.retries:
                # honest reporting: the request survived this many
                # transient failures before completing
                done["retries"] = stream.retries
            if finals[j] is not None:
                done["final_state"] = transport.encode_array(finals[j])
            if traced:
                stream.trace.add("finalize", d0, time.perf_counter())
            self.obs.flight_record(stream.request_id, "done",
                                   total_s=round(total_s, 6),
                                   cancelled=stream.cancelled)
            self._finish(stream, done)
            if not stream.cancelled:
                # per-class latency SLO samples (sliding window); shed
                # and cancelled requests never enter -- these are the
                # latencies of requests actually served
                with self._lock:
                    self._latency[stream.spec.priority].append(
                        (queue_s, total_s))
                self.obs.queue_seconds.observe(
                    queue_s, priority=stream.spec.priority)
                self.obs.total_seconds.observe(
                    total_s, priority=stream.spec.priority)
