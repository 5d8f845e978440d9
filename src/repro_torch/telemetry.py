"""Stdlib-only telemetry primitives: metrics, traces, logging setup.

This module is the substrate under ``repro_torch.serving.observability``; it
deliberately imports nothing heavier than the standard library so light
client processes (and tests) can parse ``/metrics`` or load a trace
without dragging in torch.

Three building blocks:

* **Metrics** -- ``Counter`` / ``Gauge`` / ``Histogram`` registered in a
  ``MetricsRegistry`` and rendered in Prometheus text exposition format
  (0.0.4) by ``MetricsRegistry.prometheus_text``.  Components that
  already keep authoritative internal tallies (the executable cache, the
  engine pool) export them via *collector callbacks* registered with
  ``register_collector`` -- the registry reads the live value at scrape
  time, so ``/metrics`` and ``/v1/stats`` can never disagree at
  quiescence.  ``parse_prometheus`` is the exact inverse used by tests
  and CI.
* **Traces** -- ``RequestTrace`` records a span tree against one
  monotonic clock (``time.perf_counter``); spans carry explicit parent
  ids (no thread-local magic, spans may be recorded from worker
  threads) and export as Chrome/Perfetto trace-event JSON via
  ``to_chrome``.  ``NULL_TRACE`` is the no-op twin used when tracing is
  disabled, so instrumented code never branches.
* **Program spans** -- ``span`` brackets a layer of the program (the
  engine's chunk and lead, the model's blocks, the trainer's phases)
  while a ``torch.profiler`` collects on the calling thread (the one
  that started it), and costs one check of torch's profiler state
  otherwise; ``setup_span`` brackets work done once per key (plan
  builds, kernel loads), always.  Both record into one bounded
  process-level ``RequestTrace``, read back by ``process_spans``.
  torch is reached only once it is in ``sys.modules``.
* **Logging** -- ``setup_logging`` configures the ``repro_torch`` logger
  hierarchy once, writing to stderr (stdout stays machine-readable for
  CLIs that print artifact paths).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import sys
import threading
import time
from typing import Callable, Iterable

# ---------------------------------------------------------------------------
# metrics


#: default histogram buckets for request/phase latencies, in seconds.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


def _label_key(labelnames: tuple, labels: dict) -> tuple:
    """Validate label kwargs against the declared names, return the key."""
    if set(labels) != set(labelnames):
        raise ValueError(f"expected labels {labelnames}, got "
                         f"{tuple(sorted(labels))}")
    return tuple(str(labels[n]) for n in labelnames)


class Counter:
    """A monotonically increasing metric, optionally labeled.

    By Prometheus convention the name should end in ``_total``.
    """

    typ = "counter"

    def __init__(self, name: str, help: str, labelnames: tuple = ()):
        """Create a counter; values start at 0 per label combination."""
        self.name, self.help, self.labelnames = name, help, tuple(labelnames)
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}
        if not self.labelnames:
            self._values[()] = 0.0

    def inc(self, amount: float = 1.0, **labels) -> None:
        """Add ``amount`` (must be >= 0) to the labeled series."""
        if amount < 0:
            raise ValueError("counters only go up")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        """Current value of one labeled series (0.0 if never touched)."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def values(self) -> dict[tuple, float]:
        """Snapshot of all series, keyed by label-value tuple."""
        with self._lock:
            return dict(self._values)

    def samples(self) -> list[tuple[dict, float]]:
        """All series as ``(labels_dict, value)`` pairs for rendering."""
        with self._lock:
            return [(dict(zip(self.labelnames, k)), v)
                    for k, v in sorted(self._values.items())]


class Gauge(Counter):
    """A metric that can go up and down (current queue depth, bytes)."""

    typ = "gauge"

    def inc(self, amount: float = 1.0, **labels) -> None:
        """Add ``amount`` (may be negative) to the labeled series."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set(self, value: float, **labels) -> None:
        """Set the labeled series to ``value``."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = float(value)


class Histogram:
    """A fixed-bucket histogram (cumulative ``le`` buckets on render)."""

    typ = "histogram"

    def __init__(self, name: str, help: str, labelnames: tuple = (),
                 buckets: tuple = LATENCY_BUCKETS):
        """Create a histogram over ``buckets`` (ascending upper bounds)."""
        self.name, self.help, self.labelnames = name, help, tuple(labelnames)
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        # per label key: [per-bucket counts..., +Inf count], sum, count
        self._series: dict[tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        """Record one observation into the labeled series."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._series[key] = s
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    s[0][i] += 1
                    break
            else:
                s[0][-1] += 1
            s[1] += value
            s[2] += 1

    def snapshot(self) -> dict[tuple, dict]:
        """Per-series ``{"counts": [...], "sum": s, "count": n}`` copies."""
        with self._lock:
            return {k: {"counts": list(s[0]), "sum": s[1], "count": s[2]}
                    for k, s in self._series.items()}


def _escape_label(v: str) -> str:
    """Escape a label value per the text exposition format."""
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt_labels(labels: dict) -> str:
    """Render a label dict as ``{k="v",...}`` (empty string if none)."""
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    """Render a sample value (integers without a trailing ``.0``)."""
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    """A process-local registry of metrics plus collector callbacks.

    ``counter``/``gauge``/``histogram`` are idempotent: asking for an
    existing name returns the existing instrument (and raises if the
    type or labels disagree), so independent components can share series.
    """

    def __init__(self):
        """Create an empty registry."""
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        self._collectors: list[Callable[[], Iterable[dict]]] = []

    def _get_or_make(self, cls, name, help, labelnames, **kw):
        """Idempotent instrument constructor shared by the helpers."""
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(f"metric {name!r} already registered "
                                     f"with a different type or labels")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str, labelnames: tuple = ()) -> Counter:
        """Get or create a ``Counter``."""
        return self._get_or_make(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str, labelnames: tuple = ()) -> Gauge:
        """Get or create a ``Gauge``."""
        return self._get_or_make(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str, labelnames: tuple = (),
                  buckets: tuple = LATENCY_BUCKETS) -> Histogram:
        """Get or create a ``Histogram`` with fixed ``buckets``."""
        return self._get_or_make(Histogram, name, help, labelnames,
                                 buckets=buckets)

    def register_collector(self,
                           fn: Callable[[], Iterable[dict]]) -> None:
        """Register a callback polled at scrape time.

        ``fn()`` returns an iterable of metric snapshots, each a dict
        ``{"name", "type" ("counter"|"gauge"), "help",
        "samples": [(labels_dict, value), ...]}``.  Collectors let
        components whose internal tallies are the source of truth (the
        executable cache, the engine pool) expose live values without
        double bookkeeping.
        """
        with self._lock:
            self._collectors.append(fn)

    def _iter_snapshots(self) -> list[dict]:
        """Materialize every metric and collector output as snapshots."""
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        out = []
        for m in metrics:
            if isinstance(m, Histogram):
                out.append({"name": m.name, "type": m.typ, "help": m.help,
                            "histogram": m})
            else:
                out.append({"name": m.name, "type": m.typ, "help": m.help,
                            "samples": m.samples()})
        for fn in collectors:
            out.extend(fn())
        return sorted(out, key=lambda s: s["name"])

    def prometheus_text(self) -> str:
        """Render every metric in Prometheus text exposition format."""
        lines: list[str] = []
        for snap in self._iter_snapshots():
            name, typ = snap["name"], snap["type"]
            lines.append(f"# HELP {name} {snap.get('help', '')}")
            lines.append(f"# TYPE {name} {typ}")
            if typ == "histogram":
                h: Histogram = snap["histogram"]
                for key, s in sorted(h.snapshot().items()):
                    labels = dict(zip(h.labelnames, key))
                    cum = 0
                    for ub, c in zip(h.buckets, s["counts"]):
                        cum += c
                        lab = dict(labels, le=_fmt_value(ub))
                        lines.append(f"{name}_bucket{_fmt_labels(lab)} "
                                     f"{cum}")
                    cum += s["counts"][-1]
                    lab = dict(labels, le="+Inf")
                    lines.append(f"{name}_bucket{_fmt_labels(lab)} {cum}")
                    lines.append(f"{name}_sum{_fmt_labels(labels)} "
                                 f"{_fmt_value(s['sum'])}")
                    lines.append(f"{name}_count{_fmt_labels(labels)} "
                                 f"{s['count']}")
            else:
                for labels, v in snap["samples"]:
                    lines.append(f"{name}{_fmt_labels(labels)} "
                                 f"{_fmt_value(v)}")
        return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict[tuple, float]:
    """Parse text exposition format back into ``{(name, labels): value}``.

    ``labels`` is a tuple of sorted ``(key, value)`` pairs.  Inverse of
    ``MetricsRegistry.prometheus_text`` for the subset it emits; used by
    tests and the CI smoke to assert ``/metrics`` agrees with
    ``/v1/stats``.
    """
    out: dict[tuple, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # name{labels} value  |  name value
        if "{" in line:
            name, rest = line.split("{", 1)
            raw_labels, value = rest.rsplit("}", 1)
            labels = {}
            # split on '","' boundaries without a regex: values are
            # escaped, so a simple state machine suffices
            key, buf, in_val, esc = None, [], False, False
            for ch in raw_labels + ",":
                if in_val:
                    if esc:
                        buf.append({"n": "\n"}.get(ch, ch))
                        esc = False
                    elif ch == "\\":
                        esc = True
                    elif ch == '"':
                        in_val = False
                        labels[key] = "".join(buf)
                        buf = []
                    else:
                        buf.append(ch)
                elif ch == '"':
                    in_val = True
                elif ch == "=":
                    key = "".join(buf).strip().rstrip("=")
                    buf = []
                elif ch == ",":
                    buf = []
                else:
                    buf.append(ch)
        else:
            name, value = line.rsplit(None, 1)
            labels = {}
        out[(name.strip(), tuple(sorted(labels.items())))] = float(value)
    return out


def prom_value(parsed: dict, name: str, **labels) -> float:
    """Look up one sample in ``parse_prometheus`` output (0.0 if absent)."""
    return parsed.get((name, tuple(sorted(
        (k, str(v)) for k, v in labels.items()))), 0.0)


# ---------------------------------------------------------------------------
# traces


class RequestTrace:
    """A span tree for one request, on one monotonic clock.

    Span 0 is the implicit root (``"request"``), opened at construction
    and closed by ``finish()``.  Spans carry explicit parent ids so
    worker threads can record into the same tree; ``add`` records an
    already-timed interval, ``begin``/``end`` bracket one in progress,
    and ``span`` is the context-manager sugar over the pair.
    """

    def __init__(self, request_id: str, meta: dict | None = None,
                 t0: float | None = None, capacity: int | None = None):
        """Open the trace (and its root span) for ``request_id``.

        ``t0`` backdates the root span to an already-captured
        ``perf_counter`` reading (e.g. the instant a request hit the
        admission path, before its trace object existed).  With
        ``capacity`` the trace holds at most that many spans (the root
        included); each span past it is dropped and counted in
        ``dropped``, and its ``begin``/``add`` return None.
        """
        self.request_id = request_id
        self.t0 = t0 if t0 is not None else time.perf_counter()
        self.wall_t0 = time.time()
        self.capacity = capacity
        self.dropped = 0
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._spans: list[dict] = []
        self._by_id: dict[int, dict] = {}
        self.root = self._record("request", self.t0, None, None,
                                 dict(meta or {}))

    def _record(self, name, t0, t1, parent, args, tid=None,
                device=None) -> int | None:
        """Append one span record under the lock; returns its id (None
        when the trace is full)."""
        with self._lock:
            if self.capacity is not None and \
                    len(self._spans) >= self.capacity:
                self.dropped += 1
                return None
            sid = next(self._ids)
            rec = {"id": sid, "name": name, "parent": parent,
                   "t0": t0, "t1": t1,
                   "tid": tid or threading.current_thread().name,
                   "args": dict(args or {})}
            if device is not None:
                rec["device"] = device
            self._spans.append(rec)
            self._by_id[sid] = rec
            return sid

    def begin(self, name: str, parent: int | None = 0,
              args: dict | None = None, device=None) -> int | None:
        """Open a span now; close it later with ``end``.  ``device``: the
        span's (start, end) timing events on the card, if any."""
        return self._record(name, time.perf_counter(), None, parent, args,
                            device=device)

    def end(self, sid: int | None, args: dict | None = None) -> None:
        """Close the span ``sid`` now, merging ``args`` in."""
        t1 = time.perf_counter()
        with self._lock:
            s = self._by_id.get(sid)
            if s is None:
                return
            if s["t1"] is None:
                s["t1"] = t1
            if args:
                s["args"].update(args)

    def add(self, name: str, t0: float, t1: float,
            parent: int | None = 0, args: dict | None = None,
            tid: str | None = None) -> int | None:
        """Record an already-timed ``[t0, t1]`` interval as a span."""
        return self._record(name, t0, t1, parent, args, tid=tid)

    @contextlib.contextmanager
    def span(self, name: str, parent: int | None = 0,
             args: dict | None = None):
        """Context manager bracketing a span; yields the span id."""
        sid = self.begin(name, parent=parent, args=args)
        try:
            yield sid
        finally:
            self.end(sid)

    def finish(self) -> None:
        """Close the root span (idempotent)."""
        self.end(self.root)

    @property
    def finished(self) -> bool:
        """Whether the root span has been closed."""
        with self._lock:
            return self._spans[0]["t1"] is not None

    def spans(self) -> list[dict]:
        """Copies of every span record."""
        with self._lock:
            return [dict(s) for s in self._spans]

    def to_chrome(self) -> dict:
        """Export as Chrome/Perfetto trace-event JSON (``ts`` in us)."""
        spans = self.spans()
        now = time.perf_counter()
        tids = {}
        events = [{"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
                   "args": {"name": f"request {self.request_id}"}}]
        for s in spans:
            if s["tid"] not in tids:
                tids[s["tid"]] = len(tids)
                events.append({"ph": "M", "name": "thread_name", "pid": 1,
                               "tid": tids[s["tid"]],
                               "args": {"name": s["tid"]}})
        for s in spans:
            t1 = s["t1"] if s["t1"] is not None else now
            args = dict(s["args"])
            args["span_id"] = s["id"]
            if s["parent"] is not None:
                args["parent"] = s["parent"]
            events.append({
                "name": s["name"], "ph": "X", "pid": 1,
                "tid": tids[s["tid"]],
                "ts": round((s["t0"] - self.t0) * 1e6, 3),
                "dur": round((t1 - s["t0"]) * 1e6, 3),
                "args": args})
        return {"displayTimeUnit": "ms", "traceEvents": events,
                "otherData": {"request_id": self.request_id,
                              "wall_t0_unix_s": self.wall_t0}}


class _NullTrace:
    """No-op twin of ``RequestTrace`` used when tracing is disabled.

    Every method is a do-nothing returning a harmless value, so
    instrumented code paths never branch on "is tracing on".
    """

    request_id = ""
    root = 0
    finished = True

    def begin(self, name, parent=0, args=None) -> int:
        """No-op; returns span id 0."""
        return 0

    def end(self, sid, args=None) -> None:
        """No-op."""

    def add(self, name, t0, t1, parent=0, args=None, tid=None) -> int:
        """No-op; returns span id 0."""
        return 0

    @contextlib.contextmanager
    def span(self, name, parent=0, args=None):
        """No-op context manager yielding span id 0."""
        yield 0

    def finish(self) -> None:
        """No-op."""

    def spans(self) -> list:
        """Always empty."""
        return []

    def to_chrome(self) -> dict:
        """An empty Chrome trace."""
        return {"displayTimeUnit": "ms", "traceEvents": []}


#: shared no-op trace: ``stream.trace is NULL_TRACE`` tests "untraced".
NULL_TRACE = _NullTrace()


# ---------------------------------------------------------------------------
# program spans


#: spans the process trace holds (its root included) before it drops
#: further ones, counted in ``process_trace().dropped``
PROCESS_SPAN_CAPACITY = 50_000

_process_lock = threading.Lock()
_process: RequestTrace | None = None
#: per thread, the ids of the spans open on it, innermost last
_open = threading.local()
#: torch's ``_profiler_enabled``, looked up once torch is loaded
_profiler_enabled = None


def _collecting() -> bool:
    """Whether a ``torch.profiler`` collects on this thread, as torch's
    own ``record_function`` decides (False while torch is not
    loaded)."""
    global _profiler_enabled
    if _profiler_enabled is None:
        try:
            _profiler_enabled = \
                sys.modules["torch"]._C._autograd._profiler_enabled
        except (KeyError, AttributeError):   # torch not (fully) loaded
            return False
    return _profiler_enabled()


def _device_events():
    """A (start, end) pair of timing events for the current CUDA stream,
    or None when the process has not initialized CUDA."""
    cuda = sys.modules["torch"].cuda
    if not cuda.is_initialized():
        return None
    return cuda.Event(enable_timing=True), cuda.Event(enable_timing=True)


def process_trace() -> RequestTrace:
    """The process's span store, made on first use (its root span is
    ``"request"`` of ``request_id`` ``"process"``)."""
    global _process
    with _process_lock:
        if _process is None:
            _process = RequestTrace("process",
                                    capacity=PROCESS_SPAN_CAPACITY)
        return _process


class _NullSpan:
    """The span when no profiler collects: enters and exits, records
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


#: the one object ``span`` returns while no profiler collects
NULL_SPAN = _NullSpan()


class _Span:
    """One span being recorded into the process trace; with ``hot``, also
    a ``record_function`` range and, on CUDA, a pair of timing events."""

    __slots__ = ("name", "args", "hot", "_trace", "_sid", "_range",
                 "_events")

    def __init__(self, name: str, args: dict, hot: bool):
        self.name, self.args, self.hot = name, args, hot

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self._trace = tr = process_trace()
        self._range = self._events = None
        if self.hot:
            self._range = sys.modules["torch"].profiler.record_function(
                self.name)
            self._range.__enter__()
            self._events = _device_events()
        self._sid = tr.begin(self.name, parent=stack[-1] if stack
                             else tr.root, args=self.args,
                             device=self._events)
        stack.append(self._sid)
        if self._events is not None:
            self._events[0].record()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        _open.stack.pop()
        self._trace.end(self._sid)
        if self._range is not None:
            self._range.__exit__(*exc)
        return None


def span(name: str, /, **args):
    """A context manager bracketing one layer of the program.

    While a ``torch.profiler`` collects on this thread it opens
    ``torch.profiler.record_function(name)`` (the range sits in the
    profiler's trace beside the kernels it launched), records the span
    into ``process_trace()`` under the innermost span open on this
    thread, and on CUDA records a timing event on the current stream at
    entry and at exit (``process_spans``' ``device_ms``).  Otherwise it
    returns ``NULL_SPAN`` after one check of the profiler's state.

    Never hold a span open across a ``yield``: the caller's code would
    run inside it.
    """
    if not _collecting():
        return NULL_SPAN
    return _Span(name, args, hot=True)


def setup_span(name: str, /, **args):
    """A context manager recording work done once per key per process
    (a plan build, a kernel library's load) into ``process_trace()``,
    profiler or not, with ``perf_counter`` bounds only."""
    return _Span(name, args, hot=False)


def process_spans() -> list[dict]:
    """Every span recorded into ``process_trace()`` (the root left out),
    each with ``dur_s`` (host seconds, None while open) and
    ``device_ms`` (the card's milliseconds between its two events, None
    without them); waits for each span's end event first."""
    with _process_lock:
        tr = _process
    if tr is None:
        return []
    out = []
    for s in tr.spans()[1:]:
        events = s.pop("device", None)
        done = s["t1"] is not None
        s["dur_s"] = s["t1"] - s["t0"] if done else None
        s["device_ms"] = None
        if events is not None and done:
            events[1].synchronize()
            s["device_ms"] = events[0].elapsed_time(events[1])
        out.append(s)
    return out


# ---------------------------------------------------------------------------
# logging


def setup_logging(level: str = "INFO") -> logging.Logger:
    """Configure the ``repro_torch`` logger hierarchy once (idempotent).

    Handlers write to **stderr** so CLIs whose stdout is machine-read
    (``repro_torch.launch.bundle build`` prints the bundle path last) stay
    clean.  Returns the root ``repro_torch`` logger.
    """
    logger = logging.getLogger("repro_torch")
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(h)
    logger.setLevel(getattr(logging, str(level).upper(), logging.INFO))
    return logger
