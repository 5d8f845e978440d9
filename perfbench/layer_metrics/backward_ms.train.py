"""``backward_ms.train``: device milliseconds a train step in the
gradient (the ``trainer.backward`` spans: the blocks' recomputation,
the band transpose, the CRPS backward)."""

from perfbench import spans


def read(ctx: dict) -> float | None:
    """ms a step, or None where the program records no such span."""
    return spans.per_step("trainer.backward")
