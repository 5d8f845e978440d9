"""``encoder_ms.forecast``: device milliseconds a member-lead in the
model's encoder (the ``fcn3.encoder`` spans: the three grouped DISCO
encoders of ``core/fcn3.py::FCN3._encode``)."""

from perfbench import spans


def read(ctx: dict) -> float | None:
    """ms a member-lead, or None where the program records no such span."""
    return spans.per_member_lead(("fcn3.encoder",))
