"""``adam_ms.train``: device milliseconds a train step in the optimizer
(the ``trainer.adam`` spans: the global gradient norm and Adam's
per-leaf update)."""

from perfbench import spans


def read(ctx: dict) -> float | None:
    """ms a step, or None where the program records no such span."""
    return spans.per_step("trainer.adam")
