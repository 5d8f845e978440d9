"""``decoder_ms.forecast``: device milliseconds a member-lead in the
model's decoder (the ``fcn3.decoder`` spans: the bilinear upsample, the
two grouped DISCO decoders and the softclamp)."""

from perfbench import spans


def read(ctx: dict) -> float | None:
    """ms a member-lead, or None where the program records no such span."""
    return spans.per_member_lead(("fcn3.decoder",))
