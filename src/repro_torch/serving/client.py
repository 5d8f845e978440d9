"""Thin stdlib client (and CLI) for the forecast service.

Library use::

    from repro_torch.serving.client import ForecastClient
    from repro_torch.serving.spec import RequestSpec

    c = ForecastClient(port=8771)
    for ev in c.stream(RequestSpec(members=4, lead_steps=8)):
        ...                       # chunk events as lead chunks retire
    res = c.forecast(RequestSpec(members=4, lead_steps=8))
    res.scores["crps"]            # (T, C), bit-identical to the engine

CLI (prints per-lead score lines as chunks arrive and can save a timing
report, which CI uploads as an artifact)::

    python -m repro_torch.serving.client --port 8771 --members 2 \
        --lead-steps 4 --lead-chunk 2 --timing-out serving_timing.json
"""

from __future__ import annotations

import argparse
import http.client
import json
import time

import numpy as np

from repro_torch.serving import transport
from repro_torch.serving.spec import RequestSpec


class ForecastClient:
    """Stdlib-only HTTP client: one connection per call, no torch import.

    Timeouts are split: ``connect_timeout`` bounds the TCP connect (a
    dead host should fail in seconds, not minutes) while
    ``read_timeout`` bounds each wait for the next byte of a response
    -- a streamed forecast legitimately pauses for a cold kernel build, so
    the read bound stays generous.  The legacy single ``timeout``
    argument is still accepted and becomes the read timeout.

    ``stream``/``forecast`` transparently **auto-resume**: when the
    connection dies mid-stream the client reconnects with backoff to
    ``GET /v1/stream/<id>?from=<n>`` (``n`` = events already received)
    and continues byte-identically; after ``max_resumes`` failed
    attempts it raises ``transport.StreamInterrupted`` -- a distinct,
    actionable error naming the request id and resume cursor, not a
    generic server failure.  Pass ``resume=False`` to fail fast on the
    first disconnect instead.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8771,
                 timeout: float = 600.0, connect_timeout: float = 10.0,
                 read_timeout: float | None = None,
                 resume: bool = True, max_resumes: int = 4,
                 resume_backoff_s: float = 0.25):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.connect_timeout = connect_timeout
        self.read_timeout = timeout if read_timeout is None else read_timeout
        self.resume = resume
        self.max_resumes = max(0, max_resumes)
        self.resume_backoff_s = max(0.0, resume_backoff_s)

    def _connect(self) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.connect_timeout)

    def _widen_timeout(self, conn: http.client.HTTPConnection) -> None:
        """Swap the socket to the read timeout once connected: the
        connect bound did its job, body reads get the generous one."""
        if conn.sock is not None:
            conn.sock.settimeout(self.read_timeout)

    def _get_json(self, path: str) -> dict:
        conn = self._connect()
        try:
            conn.request("GET", path)
            self._widen_timeout(conn)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise transport.ServingError(
                    f"GET {path} -> {resp.status}: {body.decode()}")
            return json.loads(body)
        finally:
            conn.close()

    def health(self, retries: int = 0, delay: float = 0.5) -> dict:
        """Liveness probe; ``retries`` makes it double as a startup wait."""
        for attempt in range(retries + 1):
            try:
                return self._get_json("/healthz")
            except (ConnectionError, OSError):
                if attempt == retries:
                    raise
                time.sleep(delay)

    def stats(self) -> dict:
        """The server's scheduler/cache/bundle statistics block."""
        return self._get_json("/v1/stats")

    def metrics(self) -> str:
        """The server's ``/metrics`` Prometheus text exposition (parse
        it with ``repro_torch.telemetry.parse_prometheus``)."""
        conn = self._connect()
        try:
            conn.request("GET", "/metrics")
            self._widen_timeout(conn)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise transport.ServingError(
                    f"GET /metrics -> {resp.status}: {body.decode()}")
            return body.decode("utf-8")
        finally:
            conn.close()

    def trace(self, request_id: str) -> dict:
        """A served request's Chrome/Perfetto trace JSON (404s raise)."""
        return self._get_json(f"/v1/trace/{request_id}")

    def debug_requests(self) -> dict:
        """The server's flight-recorder snapshot."""
        return self._get_json("/v1/debug/requests")

    def readyz(self) -> dict:
        """The replica health snapshot (state/reasons/transitions).
        Unlike a load balancer, the client accepts the 503 rendering of
        a not-ready replica -- callers inspect ``state``."""
        conn = self._connect()
        try:
            conn.request("GET", "/readyz")
            self._widen_timeout(conn)
            resp = conn.getresponse()
            return json.loads(resp.read())
        finally:
            conn.close()

    def _open_stream(self, method: str, path: str,
                     body: str | None = None):
        """One streaming HTTP exchange; returns (conn, resp) with the
        read timeout installed, raising ``ServingError`` on non-200."""
        conn = self._connect()
        try:
            headers = ({"Content-Type": "application/json"}
                       if body is not None else {})
            conn.request(method, path, body, headers)
            self._widen_timeout(conn)
            resp = conn.getresponse()
            if resp.status != 200:
                err = resp.read().decode("utf-8", "replace")
                try:
                    err = json.loads(err).get("error", err)
                except json.JSONDecodeError:
                    pass
                raise transport.ServingError(
                    f"{method} {path} -> {resp.status}: {err}")
            return conn, resp
        except BaseException:
            conn.close()
            raise

    def stream(self, spec: RequestSpec | dict):
        """Yield transport events as the server emits them (NDJSON),
        transparently resuming a dropped connection (see class doc)."""
        body = json.dumps(spec.to_dict() if isinstance(spec, RequestSpec)
                          else spec)
        request_id: str | None = None
        received = 0
        resumes = 0
        conn, resp = self._open_stream("POST", "/v1/forecast", body)
        while True:
            interrupted: Exception | None = None
            try:
                try:
                    for ev in transport.read_events(resp):
                        if request_id is None:
                            request_id = ev.get("request_id")
                        received += 1
                        yield ev
                        if ev.get("event") in transport.TERMINAL_EVENTS:
                            return
                    # close-delimited framing: EOF without a terminal
                    # event IS a disconnect, not a completed stream
                    interrupted = transport.StreamInterrupted(
                        "connection closed mid-stream (no terminal event)",
                        request_id=request_id, events_received=received)
                except (transport.StreamInterrupted, ConnectionError,
                        TimeoutError, OSError,
                        http.client.HTTPException) as e:
                    interrupted = e
            finally:
                conn.close()
            # -- the stream died mid-flight: try to resume ------------
            while True:
                if (not self.resume or request_id is None
                        or resumes >= self.max_resumes):
                    raise transport.StreamInterrupted(
                        f"stream for request {request_id or '<unknown>'} "
                        f"dropped after {received} event(s) "
                        f"({type(interrupted).__name__}: {interrupted}); "
                        + (f"gave up after {resumes} resume attempt(s)"
                           if self.resume and request_id is not None else
                           "resume disabled" if request_id is not None else
                           "no request id yet, cannot resume"),
                        request_id=request_id, events_received=received)
                time.sleep(self.resume_backoff_s * 2 ** resumes)
                resumes += 1
                try:
                    conn, resp = self._open_stream(
                        "GET", f"/v1/stream/{request_id}?from={received}")
                    break
                except transport.ServingError as e:
                    # 404/410: the server cannot resume this stream at
                    # all -- retrying the same GET would loop forever
                    raise transport.StreamInterrupted(
                        f"stream for request {request_id} dropped after "
                        f"{received} event(s) and the server refused "
                        f"the resume: {e}", request_id=request_id,
                        events_received=received) from e
                except (ConnectionError, TimeoutError, OSError) as e:
                    # server not reachable (restarting?): burn an
                    # attempt, back off longer, try again
                    interrupted = e

    def forecast(self, spec: RequestSpec | dict) -> transport.ServedForecast:
        """Block until the rollout finishes; returns assembled arrays."""
        return transport.collect(self.stream(spec))


def _spec_from_args(args: argparse.Namespace) -> RequestSpec:
    return RequestSpec(
        config=args.config, members=args.members,
        lead_steps=args.lead_steps, lead_chunk=args.lead_chunk,
        precision=args.precision, perturb=args.perturb,
        perturb_amplitude=args.perturb_amplitude,
        bred_cycles=args.bred_cycles,
        ensemble_transform=args.ensemble_transform,
        spectra=args.calibration, scored=not args.unscored,
        sample=args.sample, seed=args.seed,
        return_state=args.return_state,
        coalesce=not args.no_coalesce,
        priority=args.priority, deadline_ms=args.deadline_ms,
        degrade=args.degrade, max_retries=args.max_retries)


def main(argv=None) -> None:
    """CLI entry point: stream one forecast, print per-lead score lines,
    optionally save the timing report (``--timing-out``)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8771)
    ap.add_argument("--wait-s", type=float, default=30.0,
                    help="seconds to wait for the service to come up")
    ap.add_argument("--config", default="smoke")
    ap.add_argument("--members", type=int, default=2)
    ap.add_argument("--lead-steps", type=int, default=4)
    ap.add_argument("--lead-chunk", type=int, default=2)
    ap.add_argument("--precision", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--perturb", default="none",
                    choices=["none", "obs", "bred"])
    ap.add_argument("--perturb-amplitude", type=float, default=0.05)
    ap.add_argument("--bred-cycles", type=int, default=3)
    ap.add_argument("--ensemble-transform", action="store_true")
    ap.add_argument("--calibration", action="store_true",
                    help="request in-scan spectra too")
    ap.add_argument("--unscored", action="store_true",
                    help="skip in-scan scoring (no truth comparison)")
    ap.add_argument("--sample", type=int, default=0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--return-state", action="store_true",
                    help="include the final ensemble state (base64 fp32)")
    ap.add_argument("--no-coalesce", action="store_true",
                    help="opt this request out of server-side batching "
                         "with queued same-shape requests")
    ap.add_argument("--priority", default="batch",
                    choices=["interactive", "batch"],
                    help="QoS class: interactive requests are picked "
                         "before batch ones (batch ages up, so it "
                         "cannot starve)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="wall-clock budget from submit; the server "
                         "sheds the request (error, reason=deadline) "
                         "if it expires before pickup")
    ap.add_argument("--degrade", action="store_true",
                    help="opt in to graceful degradation: near the "
                         "deadline the server may serve the validated "
                         "member-count floor instead of missing")
    ap.add_argument("--max-retries", type=int, default=0,
                    help="server-side transient-failure retry budget "
                         "for this request (0 = fail on first error)")
    ap.add_argument("--no-resume", action="store_true",
                    help="fail fast on a mid-stream disconnect instead "
                         "of auto-resuming via GET /v1/stream/<id>")
    ap.add_argument("--connect-timeout", type=float, default=10.0,
                    help="seconds to wait for the TCP connect (reads "
                         "keep the generous streaming timeout)")
    ap.add_argument("--timing-out", default=None,
                    help="save the timing/chunk report to this JSON file")
    args = ap.parse_args(argv)
    try:
        spec = _spec_from_args(args)
        spec.validate()  # fail client-side before touching the network
    except ValueError as e:
        ap.error(str(e))

    client = ForecastClient(args.host, args.port,
                            connect_timeout=args.connect_timeout,
                            resume=not args.no_resume)
    client.health(retries=max(0, int(args.wait_s / 0.5)), delay=0.5)
    # monotonic clock: wall-clock (time.time) jumps under NTP slew and
    # produced nonsense chunk timings in long-running smoke loops
    t0 = time.perf_counter()
    report: dict = {"spec": spec.to_dict(), "chunks": []}
    done = None
    for ev in client.stream(spec):
        kind = ev["event"]
        if kind == "done":
            done = ev
        if kind == "start":
            degraded = ("" if ev.get("degraded_members") is None else
                        f" degraded_members={ev['degraded_members']}")
            print(f"[client] {ev['request_id']} accepted: "
                  f"queue={ev['queue_s']:.3f}s "
                  f"setup={ev.get('setup_s', 0.0):.3f}s "
                  f"compile={ev['compile_s']:.3f}s "
                  f"batch={ev.get('batch_size', 1)} "
                  f"cache={[o['source'] for o in ev['cache']]}"
                  f"{degraded}")
        elif kind == "chunk":
            entry = {"index": ev["index"], "lead_steps": ev["lead_steps"],
                     "chunk_s": ev["chunk_s"],
                     "scores": sorted(ev["scores"])}
            report["chunks"].append(entry)
            for i, n in enumerate(ev["lead_steps"]):
                line = f"lead {6 * (n + 1):4d}h"
                for name in ("crps", "ens_rmse", "ssr"):
                    if name in ev["scores"]:
                        v = float(np.mean(ev["scores"][name][i]))
                        line += f"  {name}={v:.4f}"
                print(f"{line}  ({time.perf_counter() - t0:.1f}s)")
        elif kind == "error":
            raise transport.ServingError(ev["message"],
                                         reason=ev.get("reason"))
    if done is None:
        # close-delimited framing: a dead server is just EOF -- refuse
        # to write a bogus "success" timing report
        raise transport.ServingError(
            "stream ended without a terminal 'done' event")
    report["request_id"] = done.get("request_id")
    report["timing"] = done.get("timing", {})
    report["cache"] = done.get("cache", {})
    # end-to-end as the *client* saw it (connect + stream + decode), to
    # compare against the server-side total_s in the same report
    report["client_total_s"] = round(time.perf_counter() - t0, 6)
    print(f"[client] done: run={report['timing'].get('run_s', 0):.3f}s "
          f"total={report['timing'].get('total_s', 0):.3f}s "
          f"batch={report['timing'].get('batch_size', 1)} "
          f"cache_misses={report['cache'].get('misses')}")
    if args.timing_out:
        with open(args.timing_out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"[client] timing report -> {args.timing_out}")


if __name__ == "__main__":
    main()
