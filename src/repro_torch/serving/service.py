"""HTTP front end: chunk-streamed NDJSON over stdlib ``http.server``.

Routes:

* ``POST /v1/forecast`` -- body is a ``RequestSpec`` JSON object
  (including the QoS fields ``priority``/``deadline_ms``/``degrade``).
  Responds 200 with an ``application/x-ndjson`` stream (see
  ``repro_torch.serving.transport`` for the event grammar), 400 on an invalid
  spec, 503 when the request queue is full or the scheduler is
  draining.  A request whose deadline expires while queued still gets a
  200 stream -- its single event is the terminal ``error`` with
  ``reason: "deadline"`` (admission control is part of the stream, not
  the HTTP status).
* ``GET /v1/stats``     -- scheduler + executable-cache statistics,
  including the ``qos`` block (per-class queue depth, shed/degraded/
  requeued counters, p50/p95 latency percentiles) and the ``bundle``
  block (warm-start provenance) on replicas booted from a warm-start
  bundle (see ``repro_torch.serving.bundle``).
* ``GET /healthz``      -- liveness; includes ``bundle_id`` when the
  replica booted from a bundle.  Always 200 while the process can
  answer -- a degraded replica is still alive.
* ``GET /readyz``       -- readiness: the replica health state machine
  (``starting -> ready -> degraded -> draining``, see
  ``repro_torch.serving.faults.ReplicaHealth``).  200 only in ``ready``;
  503 otherwise, with the state, its reasons (open circuit breakers,
  crashed workers, warming, draining) and the transition log in the
  JSON body.  Point load-balancer traffic probes here and liveness
  probes at ``/healthz``.
* ``GET /v1/stream/<request_id>?from=<seq>`` -- resume a severed
  NDJSON stream from event ordinal ``<seq>`` (events are numbered
  implicitly from 0 in stream order).  Replays the still-buffered
  events from the request's bounded replay ring, then follows live;
  the replayed bytes are identical to the unbroken stream's.  404 for
  an unknown/aged-out request id, 410 when ``<seq>`` already aged out
  of the ring (the client must restart the request).
* ``GET /metrics``      -- the scheduler's metrics registry in
  Prometheus text exposition format.  Counters here and ``/v1/stats``
  are two renderings of one store (``repro_torch.serving.observability``),
  so the views agree exactly.
* ``GET /v1/trace/<request_id>`` -- a served request's span tree as
  Chrome/Perfetto trace-event JSON (load it at ``ui.perfetto.dev``);
  404 once the trace ages out of the bounded in-memory ring (the
  service's ``--trace-dir`` flag persists every trace to disk too).
* ``GET /v1/debug/requests`` -- the flight recorder: the last N request
  lifecycle event sequences (submit/pick/shed/degrade/shrink/done...)
  for post-mortem without a debugger attached.

Framing: HTTP/1.0 close-delimited bodies.  Every stdlib client handles
them, the handler stays small, and chunk latency is dominated by device
work, not transfer encoding.  ``ThreadingHTTPServer`` gives each
connection its own thread; actual device work stays bounded by the
scheduler's worker pool, so N slow clients cannot oversubscribe the
accelerator.  N concurrent *same-shape* requests additionally coalesce
into one batched rollout inside the scheduler (when it runs with
``max_batch`` > 1) -- each connection still streams its own demuxed
NDJSON events.  A client that disconnects mid-stream gets a resume
grace window (``GET /v1/stream/<id>?from=<seq>``); only when the grace
expires unclaimed is the request cancelled -- a coalesced member is
then masked out of further chunks while its companions finish.
"""

from __future__ import annotations

import json
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.serving import transport
from repro_torch.serving.faults import InjectedFault
from repro_torch.serving.scheduler import (ForecastScheduler, QueueFull,
                                     ReplayGone)
from repro_torch.serving.spec import RequestSpec


class ForecastService:
    """Owns a scheduler and builds HTTP servers bound to it."""

    def __init__(self, scheduler: ForecastScheduler | None = None,
                 **scheduler_kwargs):
        self.scheduler = (scheduler if scheduler is not None
                          else ForecastScheduler(**scheduler_kwargs))

    def make_server(self, host: str = "127.0.0.1",
                    port: int = 0) -> ThreadingHTTPServer:
        """Bound server (``port=0`` picks an ephemeral port; read it back
        from ``server.server_address``).  Call ``serve_forever`` on it."""
        service = self

        class Handler(_ForecastHandler):
            """Per-server handler subclass carrying the service ref."""

        Handler.service = service
        return ThreadingHTTPServer((host, port), Handler)

    def close(self) -> None:
        """Drain and stop the underlying scheduler."""
        self.scheduler.close()


class _ForecastHandler(BaseHTTPRequestHandler):
    service: ForecastService

    # Quiet by default: one line per request on stderr drowns benchmarks.
    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass

    def _json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _stream_events(self, stream, events) -> None:
        """Write an NDJSON event iterator to the socket (shared by the
        POST stream and GET resume).

        The ``stream_write`` fault point fires before each write; an
        injected fault and a real broken pipe mean the same thing --
        the consumer's connection died -- so the stream is parked for
        resume (``note_disconnect``: events keep accumulating in the
        replay ring for the scheduler's grace window) instead of the
        rollout being cancelled outright.
        """
        sched = self.service.scheduler
        t_stream = time.perf_counter()
        n_events = 0
        try:
            for ev in events:
                sched.faults.fire("stream_write",
                                  request_id=stream.request_id)
                self.wfile.write(transport.dump_event(ev))
                self.wfile.flush()
                n_events += 1
        except (BrokenPipeError, ConnectionResetError, InjectedFault):
            sched.note_disconnect(stream)
        finally:
            # the stream span covers serialization + socket writes for
            # the whole NDJSON response; recorded after the trace's root
            # closed, so the on-disk dump is refreshed to include it
            sched.obs.note_stream(
                stream.trace, t_stream, time.perf_counter(), n_events)

    def _resume_stream(self) -> None:
        """GET /v1/stream/<id>?from=<seq>: replay buffered events from
        ordinal ``seq``, then follow the live stream to its terminal."""
        sched = self.service.scheduler
        parts = urllib.parse.urlsplit(self.path)
        rid = parts.path[len("/v1/stream/"):]
        try:
            from_seq = int(urllib.parse.parse_qs(parts.query)
                           .get("from", ["0"])[0])
        except ValueError:
            return self._json(400, {"error": "from must be an integer"})
        stream = sched.stream_by_id(rid)
        if stream is None:
            return self._json(404, {"error": f"unknown request {rid!r} "
                                             f"(never seen or aged out)"})
        base, end, term = stream.seq_bounds()
        if from_seq < base or (term is not None and from_seq > term):
            return self._json(410, {
                "error": (f"cannot resume {rid!r} from seq {from_seq}: "
                          f"buffered range is [{base}, {end}), terminal "
                          f"at {term}; restart the request"),
                "base": base, "end": end})
        sched.note_resume(stream, from_seq)
        self.send_response(200)
        self.send_header("Content-Type", transport.NDJSON_MIME)
        self.send_header("Connection", "close")
        self.end_headers()
        try:
            self._stream_events(stream, stream.events(from_seq))
        except ReplayGone:
            # aged out between the bounds check and the replay (a very
            # slow resume against a fast producer); headers are already
            # out, so just close -- the client's next attempt gets 410
            pass

    def do_GET(self):  # noqa: N802 - stdlib naming
        """Route GET: liveness/readiness, stats/metrics/trace/debug
        views, and stream resume."""
        if self.path == "/healthz":
            ok: dict = {"ok": True}
            info = self.service.scheduler.bundle_info
            if info is not None:
                # autoscaler-friendly: a replica advertises which warm
                # bundle it serves, so a rollout can check content ids
                ok["bundle_id"] = info.get("bundle_id")
            self._json(200, ok)
        elif self.path == "/readyz":
            snap = self.service.scheduler.health.snapshot()
            self._json(200 if snap["state"] == "ready" else 503, snap)
        elif self.path.startswith("/v1/stream/"):
            self._resume_stream()
        elif self.path == "/v1/stats":
            self._json(200, self.service.scheduler.stats())
        elif self.path == "/metrics":
            body = (self.service.scheduler.obs.metrics.prometheus_text()
                    .encode("utf-8"))
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path.startswith("/v1/trace/"):
            rid = self.path[len("/v1/trace/"):]
            trace = self.service.scheduler.trace_json(rid)
            if trace is None:
                self._json(404, {"error": f"no trace for request {rid!r} "
                                          f"(unknown id, tracing disabled, "
                                          f"or aged out of the ring)"})
            else:
                self._json(200, trace)
        elif self.path == "/v1/debug/requests":
            self._json(200, self.service.scheduler.debug_requests())
        else:
            self._json(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802 - stdlib naming
        """POST /v1/forecast: validate, submit, stream NDJSON events."""
        if self.path != "/v1/forecast":
            return self._json(404, {"error": f"no route {self.path}"})
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b"{}"
            spec = RequestSpec.from_dict(json.loads(body))
            stream = self.service.scheduler.submit(spec)
        except RuntimeError as e:
            # QueueFull, or submit() on a scheduler mid-shutdown --
            # both are "try again later", not a dropped socket
            return self._json(503, {"error": str(e)})
        except (ValueError, TypeError) as e:
            return self._json(400, {"error": str(e)})
        self.send_response(200)
        self.send_header("Content-Type", transport.NDJSON_MIME)
        self.send_header("Connection", "close")
        self.end_headers()
        self._stream_events(stream, stream.events())
