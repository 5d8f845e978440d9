"""``forward_ms.train``: device milliseconds a train step in the rollout
loss (the ``trainer.forward`` spans: noise, the checkpointed forward
and the fair-CRPS objective)."""

from perfbench import spans


def read(ctx: dict) -> float | None:
    """ms a step, or None where the program records no such span."""
    return spans.per_step("trainer.forward")
