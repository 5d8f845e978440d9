"""``disco_roofline.train``: the band contraction's share of its
roofline in a train step, forward (``disco_band_kernel``, the
recomputation included) and transpose (``disco_band_bwd_kernel``), in %.

The work is the configuration's fixed constants
``work.disco_forward.bound_s_per_step`` and
``work.disco_transpose.bound_s_per_step``, each summed per call of
max(FLOPs / 495e12, bytes / 3.35e12) by the frozen ``work`` and
``transpose_work`` formulas over the calls the port's dry run counted
in one step.
"""

KERNELS = ("disco_band_kernel", "disco_band_bwd_kernel")


def read(ctx: dict) -> float | None:
    """% of the roofline, or None where the band kernels did not run."""
    n = ctx["work"].get("steps", 0)
    work = ctx["config"].get("work", {})
    bound = sum(work.get(part, {}).get("bound_s_per_step", 0.0)
                for part in ("disco_forward", "disco_transpose"))
    t = ctx["trace"].kernel_s(lambda name: any(k in name for k in KERNELS))
    if not n or not bound or not t:
        return None
    return 100.0 * bound * n / t
