"""``disco_roofline.forecast``: the band contraction's share of its
roofline, in %: the least time the card could take for the band work of
the traced member-leads over the device time of ``disco_band_kernel``
(``csrc/disco_band.cu``).

The work is the configuration's fixed constant
``work.disco_forward.bound_s_per_member_lead``: for each call of one
lead, max(FLOPs / 495e12, bytes / 3.35e12) by the frozen ``work``
formula of the band contraction (the taps the filter really has, and
each input and output byte once), summed and divided by the members.
"""

KERNELS = ("disco_band_kernel",)


def read(ctx: dict) -> float | None:
    """% of the roofline, or None where the band kernel did not run."""
    n = ctx["work"].get("member_leads", 0)
    work = ctx["config"].get("work", {}).get("disco_forward", {})
    bound = work.get("bound_s_per_member_lead")
    t = ctx["trace"].kernel_s(lambda name: any(k in name for k in KERNELS))
    if not n or not bound or not t:
        return None
    return 100.0 * bound * n / t
