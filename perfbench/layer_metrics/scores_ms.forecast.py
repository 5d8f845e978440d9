"""``scores_ms.forecast``: device milliseconds a member-lead in the
in-loop scores (the ``engine.scores`` spans: the five scores and the
spectra of ``ForecastEngine.scores``)."""

from perfbench import spans


def read(ctx: dict) -> float | None:
    """ms a member-lead, or None where the program records no such span."""
    return spans.per_member_lead(("engine.scores",))
