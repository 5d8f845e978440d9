"""``global_blocks_ms.forecast``: device milliseconds a member-lead in
the 2 global processor blocks (the ``fcn3.block.global`` spans: the
latent SHT, the spectral filter, MLP, layer scales)."""

from perfbench import spans


def read(ctx: dict) -> float | None:
    """ms a member-lead, or None where the program records no such span."""
    return spans.per_member_lead(("fcn3.block.global",))
