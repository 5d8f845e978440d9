"""``local_blocks_ms.forecast``: device milliseconds a member-lead in the
8 local processor blocks (the ``fcn3.block.local`` spans: DISCO
convolution, MLP, layer scales)."""

from perfbench import spans


def read(ctx: dict) -> float | None:
    """ms a member-lead, or None where the program records no such span."""
    return spans.per_member_lead(("fcn3.block.local",))
