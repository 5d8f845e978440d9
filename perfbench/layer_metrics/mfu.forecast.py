"""``mfu.forecast``: the whole step's share of the card's peak over the
traced window, in %.

The model FLOPs per member-lead are the configuration's fixed constant
(``work.model_flops_per_member_lead``, counted once by the port's dry
run on fake tensors); the peak is the data sheet's dense TF32 rate of
one H100 SXM, 495e12 FLOP/s: no product that keeps fp32 inputs runs
faster, so no later path of the program can read above 100 %.
"""

PEAK_FLOPS = 495e12


def read(ctx: dict) -> float | None:
    """% of the peak, or None when the window holds no member-lead."""
    n = ctx["work"].get("member_leads", 0)
    flops = ctx["config"].get("work", {}).get("model_flops_per_member_lead")
    if not n or not flops or not ctx["trace"].window_s:
        return None
    return 100.0 * flops * n / ctx["trace"].window_s / PEAK_FLOPS
