"""Fault-tolerance primitives for the serving stack.

Three pieces, all stdlib-only (the thin client and the cache import
this module, so it must not drag torch in):

* **Deterministic fault injection** (``FaultInjector``): the serving
  stack is instrumented with *named fault points* -- engine build,
  key warm-up (kernel build), bundled-library load, per-chunk rollout,
  H2D staging, score fetch, disk cache read/write, stream write, the
  worker loop -- each a
  ``faults.fire("point")`` call that is a no-op until a fault is
  *armed* for that point.  Arming specs are deterministic (fire on the
  Nth occurrence, the first K occurrences, or a seeded Bernoulli per
  occurrence), so every failure path in the scheduler/cache/service is
  exercised by tests and the CI chaos smoke instead of merely believed.
  ``NULL_FAULTS`` is the shared no-op twin (the ``NULL_TRACE`` pattern):
  schedulers built without ``--fault`` args hold it, so the on-path
  cost of the substrate when disabled is one attribute lookup and an
  empty method call -- and behavior is bit-identical.

* **Error classification** (``classify_error``): transient errors
  (injected transient faults, OS/connection hiccups, the card running
  out of memory) are retryable; everything else
  -- validation errors, model bugs, readonly-cache refusals -- is
  permanent and fails fast.  The scheduler's retry loop keys off this.

* **Circuit breaker** (``CircuitBreaker``) and the **replica health
  state machine** (``ReplicaHealth``): N consecutive build/compile
  failures for one engine key open the breaker -- later requests for
  that key shed instantly (reason ``"circuit_open"``) instead of
  burning build time -- and after a cooldown a single half-open
  probe decides between closing and re-opening.  ``ReplicaHealth``
  folds breaker and worker-crash signals into the
  ``starting -> ready -> degraded -> draining`` state served at
  ``GET /readyz`` (distinct from ``/healthz`` liveness), recording
  every transition for post-mortems and the CI chaos assertions.

The JAX package's docs/serving.md#fault-tolerance has the catalog
and semantics; the port keeps them.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time

#: every instrumented fault point, and where it fires.
FAULT_POINTS = (
    "engine_build",   # scheduler: cold ForecastEngine construction
    "compile",        # cache: warming a key that needs building (nvcc)
    "import_chunk",   # cache: loading a persisted kernel library
    "rollout_chunk",  # scheduler: per-chunk rollout dispatch loop
    "h2d_stage",      # scheduler: host staging of one aux/truth step
    "score_fetch",    # scheduler: device->host score download
    "cache_read",     # cache: reading a persisted library off disk
    "cache_write",    # cache: writing a freshly built library to disk
    "stream_write",   # service: writing one NDJSON event to the socket
    "worker",         # scheduler: top of the worker loop (thread crash)
)

_KINDS = ("transient", "permanent")


class InjectedFault(RuntimeError):
    """Raised by an armed fault point.  ``transient`` drives the
    scheduler's retry classification (a permanent injected fault must
    fail the request immediately, exactly like a real model bug)."""

    def __init__(self, point: str, occurrence: int, kind: str):
        self.point = point
        self.occurrence = occurrence
        self.transient = kind == "transient"
        super().__init__(f"injected {kind} fault at {point!r} "
                         f"(occurrence {occurrence})")


class CircuitOpenError(RuntimeError):
    """A request was shed fast because its engine key's circuit is open
    (terminal ``error`` event with ``reason: "circuit_open"``)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed fault: a point plus a deterministic trigger.

    Exactly one of ``n`` (fire on the Nth occurrence only), ``first``
    (fire on occurrences 1..K) or ``p`` (seeded Bernoulli per
    occurrence) selects the trigger; ``kind`` selects how the scheduler
    classifies the failure.  The CLI grammar is
    ``point:key=value[,key=value...]``, e.g. ``rollout_chunk:n=2`` or
    ``compile:first=3,kind=permanent`` or ``h2d_stage:p=0.25,seed=7``.
    """

    point: str
    n: int | None = None
    first: int | None = None
    p: float | None = None
    seed: int = 0
    kind: str = "transient"

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {self.point!r}; "
                             f"expected one of {sorted(FAULT_POINTS)}")
        triggers = [t for t in (self.n, self.first, self.p) if t is not None]
        if len(triggers) != 1:
            raise ValueError(
                f"fault spec for {self.point!r} needs exactly one of "
                f"n=, first=, p= (got {len(triggers)})")
        if self.n is not None and self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        if self.first is not None and self.first < 1:
            raise ValueError(f"first must be >= 1, got {self.first}")
        if self.p is not None and not 0.0 < self.p <= 1.0:
            raise ValueError(f"p must be in (0, 1], got {self.p}")
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, "
                             f"got {self.kind!r}")

    @classmethod
    def parse(cls, arg: str) -> "FaultSpec":
        """Parse one ``--fault point:spec`` CLI argument."""
        point, sep, rest = arg.partition(":")
        if not sep or not rest:
            raise ValueError(
                f"bad fault spec {arg!r}: expected 'point:key=value[,...]' "
                f"(e.g. 'rollout_chunk:n=2')")
        kwargs: dict = {}
        for part in rest.split(","):
            k, sep, v = part.partition("=")
            if not sep:
                raise ValueError(f"bad fault spec {arg!r}: "
                                 f"{part!r} is not key=value")
            if k in ("n", "first", "seed"):
                kwargs[k] = int(v)
            elif k == "p":
                kwargs[k] = float(v)
            elif k == "kind":
                kwargs[k] = v
            else:
                raise ValueError(
                    f"bad fault spec {arg!r}: unknown key {k!r} (expected "
                    f"n, first, p, seed or kind)")
        return cls(point=point, **kwargs)

    def describe(self) -> str:
        """The spec back in CLI grammar (for stats/logs)."""
        trig = (f"n={self.n}" if self.n is not None
                else f"first={self.first}" if self.first is not None
                else f"p={self.p},seed={self.seed}")
        out = f"{self.point}:{trig}"
        if self.kind != "transient":
            out += f",kind={self.kind}"
        return out


class FaultInjector:
    """Armed fault points with deterministic triggers and counters.

    ``fire(point)`` counts the occurrence, decides per the armed spec,
    and raises ``InjectedFault`` on a hit.  Occurrence counting and the
    per-point seeded RNG make every decision reproducible: the same
    armed injector against the same request sequence fires at exactly
    the same sites, so tests and the CI chaos smoke are deterministic.
    """

    enabled = True

    def __init__(self, specs: tuple[FaultSpec, ...] | list = ()):
        self._lock = threading.Lock()
        self._specs: dict[str, FaultSpec] = {}
        self._rngs: dict[str, random.Random] = {}
        self._occurrences: dict[str, int] = {}
        self._fired: dict[str, int] = {}
        for spec in specs:
            self.arm(spec)

    @classmethod
    def from_args(cls, args: list[str]) -> "FaultInjector":
        """Build an injector from repeated ``--fault point:spec`` args."""
        return cls([FaultSpec.parse(a) for a in args])

    def arm(self, spec: FaultSpec | str) -> None:
        """Arm (or replace) the fault for ``spec.point``."""
        if isinstance(spec, str):
            spec = FaultSpec.parse(spec)
        with self._lock:
            self._specs[spec.point] = spec
            self._rngs[spec.point] = random.Random(spec.seed)

    def fire(self, point: str, **ctx) -> None:
        """Count one occurrence of ``point``; raise if the armed spec
        says this occurrence fails.  ``ctx`` is log-only color."""
        with self._lock:
            k = self._occurrences.get(point, 0) + 1
            self._occurrences[point] = k
            spec = self._specs.get(point)
            if spec is None:
                return
            hit = (spec.n == k
                   or (spec.first is not None and k <= spec.first)
                   or (spec.p is not None
                       and self._rngs[point].random() < spec.p))
            if not hit:
                return
            self._fired[point] = self._fired.get(point, 0) + 1
            kind = spec.kind
        raise InjectedFault(point, k, kind)

    def stats(self) -> dict:
        """Armed specs plus occurrence/fire counters per point."""
        with self._lock:
            return {"armed": sorted(s.describe()
                                    for s in self._specs.values()),
                    "occurrences": dict(self._occurrences),
                    "fired": dict(self._fired)}


class _NullFaultInjector:
    """No-op twin of ``FaultInjector``: the default when no fault is
    armed, so instrumented code never branches on "is injection on"."""

    enabled = False

    def fire(self, point: str, **ctx) -> None:
        """No-op."""

    def stats(self) -> dict:
        """Always empty."""
        return {"armed": [], "occurrences": {}, "fired": {}}


#: shared no-op injector: ``sched.faults is NULL_FAULTS`` tests "unarmed".
NULL_FAULTS = _NullFaultInjector()


def classify_error(exc: BaseException) -> str:
    """``"transient"`` (retryable) or ``"permanent"`` (fail fast).

    Injected faults carry their own classification.  OS-level hiccups
    (disk, sockets, timeouts) and out-of-memory conditions -- the host's
    ``MemoryError`` and torch's ``OutOfMemoryError`` on the card -- are
    transient: a retry after backoff plausibly succeeds once another
    request's tensors are freed.  Everything else (validation errors,
    shape bugs, a failed kernel build, readonly cache refusals) is
    permanent: retrying deterministic breakage just burns device time.
    torch's error is matched by name, so this module stays stdlib-only.
    """
    if isinstance(exc, InjectedFault):
        return "transient" if exc.transient else "permanent"
    if isinstance(exc, (ConnectionError, TimeoutError, MemoryError)):
        return "transient"
    if isinstance(exc, OSError):
        return "transient"
    if type(exc).__name__ == "OutOfMemoryError":
        return "transient"
    return "permanent"


class CircuitBreaker:
    """Consecutive-failure circuit for one engine key's build/compile.

    closed -> (``threshold`` consecutive failures) -> open -> (after
    ``cooldown_s``) -> half-open: ``allow`` grants exactly one probe;
    the probe's success closes the circuit, its failure re-opens it for
    another cooldown.  While open, ``allow`` returns False and the
    scheduler sheds the request with reason ``"circuit_open"`` without
    touching engine build or compile -- the whole point is that a
    poisoned key (bad checkpoint, OOM-at-compile shape) stops burning
    minutes of building per arriving request.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 clock=time.monotonic):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at: float | None = None
        self._probing = False
        self._opens = 0

    @property
    def state(self) -> str:
        """``"closed"``, ``"open"`` or ``"half_open"``."""
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """Whether a request for this key may proceed to build/compile.
        The first call after the cooldown flips open -> half-open and
        grants the probe; concurrent calls during the probe are denied."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if (self._opened_at is not None
                        and self._clock() - self._opened_at
                        >= self.cooldown_s):
                    self._state = "half_open"
                    self._probing = True
                    return True
                return False
            # half_open: one probe at a time
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> bool:
        """Build/compile succeeded; returns True when this closed a
        previously open/half-open circuit."""
        with self._lock:
            was_open = self._state != "closed"
            self._state = "closed"
            self._failures = 0
            self._probing = False
            self._opened_at = None
            return was_open

    def record_failure(self) -> bool:
        """Build/compile failed; returns True when this opened (or
        re-opened) the circuit."""
        with self._lock:
            if self._state == "half_open":
                self._state = "open"
                self._opened_at = self._clock()
                self._probing = False
                self._opens += 1
                return True
            self._failures += 1
            if self._state == "closed" and self._failures >= self.threshold:
                self._state = "open"
                self._opened_at = self._clock()
                self._opens += 1
                return True
            return False

    def snapshot(self) -> dict:
        """Point-in-time state for stats/metrics."""
        with self._lock:
            out = {"state": self._state,
                   "consecutive_failures": self._failures,
                   "opens": self._opens,
                   "threshold": self.threshold,
                   "cooldown_s": self.cooldown_s}
            if self._state == "open" and self._opened_at is not None:
                out["cooldown_remaining_s"] = round(max(
                    0.0, self.cooldown_s
                    - (self._clock() - self._opened_at)), 3)
            return out


#: replica health states, in order of the lifecycle.
HEALTH_STATES = ("starting", "ready", "degraded", "draining")


class ReplicaHealth:
    """The replica health state machine behind ``GET /readyz``.

    ``starting`` until ``mark_ready`` (the launcher calls it after
    preload + warmup), ``draining`` once ``close()`` begins, and
    ``degraded`` whenever any circuit breaker is open or a crashed
    worker has not been restarted yet -- otherwise ``ready``.  Every
    state change is recorded with a wall-clock timestamp so chaos tests
    and post-mortems can assert the transition sequence rather than
    race a poll against a fast recovery.
    """

    def __init__(self, ready: bool = True, clock=time.time):
        self._clock = clock
        self._lock = threading.Lock()
        self._ready = ready
        self._draining = False
        self._open_breakers: set[str] = set()
        self._dead_workers = 0
        self._state = self._compute()
        self.transitions = [{"state": self._state,
                             "t_unix_s": round(self._clock(), 3)}]

    def _compute(self) -> str:
        if self._draining:
            return "draining"
        if not self._ready:
            return "starting"
        if self._open_breakers or self._dead_workers > 0:
            return "degraded"
        return "ready"

    def _update_locked(self) -> None:
        state = self._compute()
        if state != self._state:
            self._state = state
            self.transitions.append({"state": state,
                                     "t_unix_s": round(self._clock(), 3)})

    def mark_ready(self) -> None:
        """Preload/warmup finished: starting -> ready (idempotent)."""
        with self._lock:
            self._ready = True
            self._update_locked()

    def mark_draining(self) -> None:
        """``close()`` began: terminal state, never leaves."""
        with self._lock:
            self._draining = True
            self._update_locked()

    def set_breaker(self, label: str, open_: bool) -> None:
        """Track one engine key's breaker contribution to degraded."""
        with self._lock:
            (self._open_breakers.add if open_
             else self._open_breakers.discard)(label)
            self._update_locked()

    def set_dead_workers(self, n: int) -> None:
        """Crashed-but-not-yet-restarted worker count."""
        with self._lock:
            self._dead_workers = max(0, int(n))
            self._update_locked()

    @property
    def state(self) -> str:
        """The current health state."""
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        """The ``/readyz`` payload: state, reasons, transition log."""
        with self._lock:
            reasons = []
            if not self._ready and not self._draining:
                reasons.append("warming")
            reasons += [f"circuit_open:{b}"
                        for b in sorted(self._open_breakers)]
            if self._dead_workers:
                reasons.append(f"workers_down:{self._dead_workers}")
            if self._draining:
                reasons.append("draining")
            return {"state": self._state, "reasons": reasons,
                    "transitions": list(self.transitions)}
