"""``idle_share.forecast``: the share of the traced window in which
nothing ran on the card, in %: 1 - (the union of the intervals of every
kernel, copy and set on every stream) / the window."""


def read(ctx: dict) -> float | None:
    """% idle, or None where the card ran nothing."""
    tr = ctx["trace"]
    busy = tr.busy_s()
    if not busy or not tr.window_s:
        return None
    return 100.0 * (1.0 - busy / tr.window_s)
