"""``engine_ms.forecast``: device milliseconds a member-lead in the
engine around the model step: the ``engine.lead`` spans less their
``fcn3.forward`` spans (the noise draws and fields, the casts, the
noise transition, the scores and the diagnostics hook)."""

from perfbench import spans


def read(ctx: dict) -> float | None:
    """ms a member-lead, or None where the program records no such span."""
    return spans.per_member_lead(("engine.lead",), less=("fcn3.forward",))
