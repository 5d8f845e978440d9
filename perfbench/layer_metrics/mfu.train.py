"""``mfu.train``: the whole train step's share of the card's peak over
the traced window, in %.

The model FLOPs per step are the configuration's fixed constant
(``work.model_flops_per_step``: three times the counted forward of the
step's members, the recomputation of the checkpointed blocks left out);
the peak is the dense TF32 rate of one H100 SXM, 495e12 FLOP/s.
"""

PEAK_FLOPS = 495e12


def read(ctx: dict) -> float | None:
    """% of the peak, or None when the window holds no step."""
    n = ctx["work"].get("steps", 0)
    flops = ctx["config"].get("work", {}).get("model_flops_per_step")
    if not n or not flops or not ctx["trace"].window_s:
        return None
    return 100.0 * flops * n / ctx["trace"].window_s / PEAK_FLOPS
