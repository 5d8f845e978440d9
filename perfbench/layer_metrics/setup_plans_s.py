"""``setup_plans_s``: host seconds of the process in host-side plan and
table builds (the ``plans.build`` set-up spans: DISCO plans and their
banded layouts, Legendre tables, the resample), each cache miss once."""

from perfbench import spans


def read(ctx: dict) -> float | None:
    """Seconds, or None where the program records no such span."""
    return spans.setup_seconds("plans.build")
