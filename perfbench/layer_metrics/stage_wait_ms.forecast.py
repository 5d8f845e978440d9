"""``stage_wait_ms.forecast``: host milliseconds a member-lead the
compute thread waits for a chunk's staged inputs (the profiler's ranges
of the ``engine.stage_wait`` spans, on its own clock: the stager's
future and the copy stream's event)."""

from perfbench import spans


def read(ctx: dict) -> float | None:
    """ms a member-lead, or None where the program records no such span."""
    return spans.host_ms_per_member_lead(ctx["trace"], "engine.stage_wait")
