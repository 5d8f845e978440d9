"""NDJSON chunk-stream wire format for the forecast service.

A served forecast is a stream of newline-delimited JSON events, one per
line, emitted in order:

* ``start`` -- request accepted and its keys warm: echoed ``spec``,
  ``queue_s`` (time spent waiting for a worker), ``compile_s`` (time
  spent warming this request's keys: kernel builds or loads and the
  engine's geometry and buffer set-up, see ``repro_torch.serving.cache``;
  0.0 on a warm cache hit), ``batch_size``/``batch_index`` (how many coalesced
  requests share this rollout and this request's slot in it) and the
  per-chunk-length ``cache`` outcomes.
* ``chunk`` -- one retired ``lead_chunk``: global ``lead_steps``, the
  in-loop ``scores`` for those leads and ``chunk_s`` wall time.  Chunks
  arrive as the rollout retires them, not at rollout end.
* ``done`` -- rollout finished: the timing summary, per-request cache
  totals, and (when requested) the final ensemble state.  A request
  cancelled while still queued gets a zero-chunk ``done`` with
  ``cancelled: true`` (no start event, no rollout); a request served
  under the degrade policy carries ``degraded_members``, the member
  count actually rolled.
* ``error`` -- terminal failure; ``message`` says why.  Admission-
  control errors additionally carry a machine-readable ``reason``:
  ``"deadline"`` (shed unserved after its deadline expired) or
  ``"shutdown"`` (scheduler close() timed out with the stream open).

Scores travel as plain JSON numbers: float32 -> float64 is exact,
``json`` emits the shortest round-tripping decimal, and the float64 ->
float32 cast on the way back is exact again -- so served scores are
**bit-identical** to the engine's arrays.  Bulk fp32 tensors (the final
ensemble state) use base64-encoded raw bytes instead: equally exact,
~3x denser than decimal text.  Base64 text needs no JSON escaping, so
``dump_event`` splices it into the line and ``read_events`` cuts it out
before parsing (a 2-member ``fcn3_full`` state is 0.8 GB of it): the
bytes on the wire are ``json.dumps``'s own.

Raw member fields other than an explicitly requested final state never
enter the transport -- the paper's in-situ scoring design extends to the
wire.
"""

from __future__ import annotations

import base64
import dataclasses
import json
from typing import Iterable, Iterator

import numpy as np

NDJSON_MIME = "application/x-ndjson"

#: events that end a stream
TERMINAL_EVENTS = ("done", "error")


class ServingError(RuntimeError):
    """A request failed server-side (validation, admission control or
    mid-rollout).  ``reason`` is the error event's machine-readable
    reason when it carried one ("deadline", "shutdown"), else None."""

    def __init__(self, message: str, reason: str | None = None):
        super().__init__(message)
        self.reason = reason


class StreamInterrupted(ServingError):
    """The connection died mid-stream -- distinct from a server-side
    failure: the server may well still be rolling the forecast, and a
    ``GET /v1/stream/<id>?from=<seq>`` within the resume grace picks
    the stream back up.  ``request_id``/``events_received`` carry what
    the client knew when the connection dropped (the resume cursor)."""

    def __init__(self, message: str, request_id: str | None = None,
                 events_received: int = 0):
        super().__init__(message, reason="disconnected")
        self.request_id = request_id
        self.events_received = events_received


def encode_array(a) -> dict:
    """Exact binary encoding of an ndarray as a JSON-safe dict."""
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "b64": base64.b64encode(a.tobytes()).decode("ascii")}


def _np_dtype(name: str) -> np.dtype:
    try:
        return np.dtype(name)
    except TypeError:
        # bfloat16 etc. live in ml_dtypes; importing it registers them
        # with numpy without dragging torch into a light client process
        import ml_dtypes  # noqa: F401
        return np.dtype(name)


def decode_array(d: dict) -> np.ndarray:
    """Exact inverse of ``encode_array`` (returns a writable copy)."""
    return np.frombuffer(base64.b64decode(d["b64"]),
                         dtype=_np_dtype(d["dtype"])
                         ).reshape(d["shape"]).copy()


#: an encoded array's base64 text in a line: this key, then the text up
#: to the next quote (JSON escapes every quote inside a string)
_B64 = b'"b64":"'


def _without_b64(tree, texts: list):
    """``tree`` with every base64 text (a string under a "b64" key)
    replaced by "", the texts appended to ``texts`` in the order
    ``json`` writes them."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "b64" and isinstance(v, str):
                texts.append(v)
                out[k] = ""
            else:
                out[k] = _without_b64(v, texts)
        return out
    if isinstance(tree, (list, tuple)):
        return [_without_b64(v, texts) for v in tree]
    return tree


def _put_b64(tree, texts: Iterator[str]) -> None:
    """Put ``texts`` back where ``_loads`` cut them out of ``tree``: the
    "b64" strings, in the order ``json`` wrote them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "b64" and isinstance(v, str):
                tree[k] = next(texts)
            else:
                _put_b64(v, texts)
    elif isinstance(tree, list):
        for v in tree:
            _put_b64(v, texts)


def dump_event(ev: dict) -> bytes:
    """One NDJSON line (compact separators, trailing newline): the bytes
    of ``json.dumps``, an encoded array's base64 text spliced in."""
    texts: list[str] = []
    head = json.dumps(_without_b64(ev, texts),
                      separators=(",", ":")).encode("utf-8")
    parts = head.split(_B64 + b'"')
    out = [parts[0]]
    for text, part in zip(texts, parts[1:]):
        out += [_B64, text.encode("ascii"), b'"', part]
    return b"".join(out) + b"\n"


def _loads(line: bytes) -> dict:
    """``json.loads`` of one line, its base64 texts cut out before the
    parse and put back after it."""
    texts, pieces, pos = [], [], 0
    while (i := line.find(_B64, pos)) >= 0:
        i += len(_B64)
        j = line.index(b'"', i)
        pieces.append(line[pos:i])
        texts.append(line[i:j].decode("ascii"))
        pos = j
    if not texts:
        return json.loads(line)
    pieces.append(line[pos:])
    ev = json.loads(b"".join(pieces))
    _put_b64(ev, iter(texts))
    return ev


def read_events(fp) -> Iterator[dict]:
    """Parse events from a binary line stream (socket file / HTTP body).

    A half-written line (server died mid-write under close-delimited
    framing) surfaces as ``StreamInterrupted`` (a ``ServingError``
    subclass, so existing handlers still catch it -- and the client's
    auto-resume can distinguish a dropped connection from a server-side
    failure) -- never a raw json error.
    """
    for line in iter(fp.readline, b""):
        line = line.strip()
        if line:
            try:
                ev = _loads(line)
            except (ValueError, StopIteration) as e:
                raise StreamInterrupted(
                    f"corrupt NDJSON line (connection died mid-write?): "
                    f"{e}") from e
            yield ev


def chunk_event(request_id: str, index: int, block) -> dict:
    """Encode one ``ForecastResult`` block (scores only -- raw member
    fields never leave the device, let alone the process).  ``block``'s
    scores are host numpy arrays: the scheduler's fetch thread copies the
    engine's device tensors to the host before encoding."""
    return {
        "event": "chunk",
        "request_id": request_id,
        "index": index,
        "lead_steps": [int(n) for n in block.lead_steps],
        "scores": {k: np.asarray(v, np.float32).tolist()
                   for k, v in block.scores.items()},
    }


@dataclasses.dataclass
class ServedForecast:
    """A client-side forecast assembled from a chunk stream.

    scores hold fp32 arrays concatenated over chunks, keyed like
    ``ForecastResult.scores`` ((T, C) skill scores, (T, C, E+1) rank
    histogram, (T, C, L) spectra); ``timing``/``cache`` come from the
    ``done`` event; ``chunks`` keeps the per-chunk metadata (lead_steps,
    chunk_s) for latency analysis.
    """

    request_id: str
    spec: dict
    lead_steps: np.ndarray
    scores: dict[str, np.ndarray]
    timing: dict
    cache: dict
    chunks: list[dict]
    final_state: np.ndarray | None = None
    #: True when the rollout was cancelled mid-stream -- the scores then
    #: cover fewer leads than requested (not a completed forecast)
    cancelled: bool = False
    #: how many coalesced requests shared this forecast's rollout (1 =
    #: served solo) and this request's slot in that batch
    batch_size: int = 1
    batch_index: int = 0
    #: member count actually served when the scheduler's degrade policy
    #: traded ensemble size for the deadline (None = served as asked)
    degraded_members: int | None = None
    #: transient failures this request survived (the done event's
    #: ``retries`` field; 0 = served on the first dispatch)
    retries: int = 0


def collect(events: Iterable[dict]) -> ServedForecast:
    """Fold an event stream into a ``ServedForecast``.

    Raises ``ServingError`` when the stream ends with an error event --
    or without a terminal event at all (close-delimited HTTP framing
    means a dead server just looks like EOF; a truncated stream must
    not pass for a completed forecast).
    """
    spec: dict = {}
    request_id = ""
    parts: dict[str, list[np.ndarray]] = {}
    leads: list[int] = []
    chunks: list[dict] = []
    timing: dict = {}
    cache: dict = {}
    final_state = None
    done = False
    cancelled = False
    batch_size, batch_index = 1, 0
    degraded_members = None
    retries = 0
    for ev in events:
        kind = ev.get("event")
        if kind == "start":
            request_id = ev.get("request_id", "")
            spec = ev.get("spec", {})
            batch_size = int(ev.get("batch_size", 1))
            batch_index = int(ev.get("batch_index", 0))
            if ev.get("degraded_members") is not None:
                degraded_members = int(ev["degraded_members"])
        elif kind == "chunk":
            leads.extend(ev["lead_steps"])
            for name, rows in ev["scores"].items():
                parts.setdefault(name, []).append(
                    np.asarray(rows, np.float32))
            chunks.append({k: ev[k] for k in ("index", "lead_steps",
                                              "chunk_s") if k in ev})
        elif kind == "done":
            done = True
            cancelled = bool(ev.get("cancelled", False))
            timing = ev.get("timing", {})
            cache = ev.get("cache", {})
            if not request_id:
                # a cancel-at-pickup done is the stream's only event
                # (zero chunks, no start); still identify the request
                request_id = ev.get("request_id", "")
            if ev.get("degraded_members") is not None:
                degraded_members = int(ev["degraded_members"])
            retries = int(ev.get("retries", 0))
            if "final_state" in ev:
                final_state = decode_array(ev["final_state"])
        elif kind == "error":
            raise ServingError(ev.get("message", "unknown serving error"),
                               reason=ev.get("reason"))
    if not done:
        raise ServingError(
            f"stream ended after {len(chunks)} chunk(s) without a "
            f"terminal 'done' event (server died or connection dropped)")
    scores = {k: np.concatenate(v) for k, v in parts.items()}
    return ServedForecast(request_id=request_id, spec=spec,
                          lead_steps=np.asarray(leads), scores=scores,
                          timing=timing, cache=cache, chunks=chunks,
                          final_state=final_state, cancelled=cancelled,
                          batch_size=batch_size, batch_index=batch_index,
                          degraded_members=degraded_members,
                          retries=retries)
