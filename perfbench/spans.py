"""The port's own spans as the per-layer metrics read them.

``repro_torch.telemetry.process_spans()`` returns every span the program
recorded in this process.  Its hot spans (the engine's, the model's, the
trainer's) are recorded only while a ``torch.profiler`` collects, so in
a traced run they are the traced window's; its set-up spans
(``plans.build``, ``kernels.load``) are recorded always, once per key.
A program without that function (an older commit) records no span, and
every reader then gives None.
"""

from __future__ import annotations


def program_spans() -> list[dict] | None:
    """The program's spans, or None where it has no span API."""
    from repro_torch import telemetry
    read = getattr(telemetry, "process_spans", None)
    return read() if read is not None else None


def device_ms(spans: list[dict], name: str) -> float | None:
    """Summed device milliseconds of the spans named ``name``; None
    where there is none or one has no device time."""
    got = [s["device_ms"] for s in spans if s["name"] == name]
    if not got or any(ms is None for ms in got):
        return None
    return sum(got)


def member_leads(spans: list[dict]) -> int:
    """The member-leads of the ``engine.lead`` spans: the program's own
    count of the window's work."""
    return sum(s["args"].get("member_leads", 0) for s in spans
               if s["name"] == "engine.lead")


def steps(spans: list[dict]) -> int:
    """The train steps of the ``trainer.step`` spans."""
    return sum(s["name"] == "trainer.step" for s in spans)


def per_member_lead(names: tuple[str, ...], less: tuple[str, ...] = ()
                    ) -> float | None:
    """Device ms a member-lead in the spans ``names``, less those in the
    spans ``less``; None where any of them is missing."""
    spans = program_spans()
    if not spans:
        return None
    n = member_leads(spans)
    ms = [device_ms(spans, name) for name in names + less]
    if not n or any(m is None for m in ms):
        return None
    return (sum(ms[:len(names)]) - sum(ms[len(names):])) / n


def per_step(name: str) -> float | None:
    """Device ms a train step in the spans ``name``; None where there is
    none."""
    spans = program_spans()
    if not spans:
        return None
    n, ms = steps(spans), device_ms(spans, name)
    if not n or ms is None:
        return None
    return ms / n


def host_ms_per_member_lead(trace, name: str) -> float | None:
    """Host ms a member-lead in the profiler's ranges named ``name``
    (``Trace.host``, on the profiler's clock); None where the program
    counts no member-lead or the trace has no such range."""
    spans = program_spans()
    n = member_leads(spans) if spans else 0
    if not n or trace is None:
        return None
    got = [b - a for host, a, b in trace.host if host == name]
    return 1e3 * sum(got) / n if got else None


def setup_seconds(name: str) -> float | None:
    """Seconds in the set-up spans named ``name``, a span inside another
    of that name counted once with it; None where there is none."""
    spans = program_spans()
    if not spans:
        return None
    by_id = {s["id"]: s for s in spans}

    def inside(s):
        p = by_id.get(s["parent"])
        while p is not None:
            if p["name"] == name:
                return True
            p = by_id.get(p["parent"])
        return False

    got = [s["dur_s"] for s in spans if s["name"] == name
           and s["dur_s"] is not None and not inside(s)]
    return sum(got) if got else None
