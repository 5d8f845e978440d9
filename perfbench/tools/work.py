"""Frozen copies of the band contraction's work formulas, the yardstick
of ``disco_roofline.*``: the FLOPs the data needs (the filter's live
taps, ``nnz``, at every output longitude) and every byte once.  Copied
from ``repro_torch/kernels/disco/ops.py`` (``work``, ``transpose_work``)
when the benchmark was written; a later change to the program does not
move them."""

from __future__ import annotations

#: dense TF32 rate and HBM bandwidth of one H100 SXM (data sheet, 700 W)
PEAK_FLOPS, PEAK_BYTES_S = 495e12, 3.35e12


def band_work(x_shape, psi_shape, stride: int, nnz: int) -> dict:
    """One band contraction of x (B, H_in, W_in) with a band (K, H_out,
    S, D) of ``nnz`` non-zeros: x, the band, ``lat_idx`` and the output
    once each."""
    b, h_in, w_in = x_shape
    k, h_out, s, d = psi_shape
    w_out = w_in // stride
    return {"flops": 2.0 * nnz * w_out * b,
            "bytes": 4.0 * (b * h_in * w_in + k * h_out * s * d + h_out * s
                            + b * k * h_out * w_out)}


def transpose_work(g_shape, psi_shape, h_in: int, stride: int, nnz: int,
                   list_numel: int) -> dict:
    """One transpose: the same taps; g, the live taps and their lists by
    input row (``list_numel`` entries) in, the input's gradient out."""
    b, k, h_out, w_out = g_shape
    return {"flops": 2.0 * nnz * w_out * b,
            "bytes": 4.0 * (b * k * h_out * w_out + list_numel
                            + b * h_in * w_out * stride)}


def bound_s(work: dict) -> float:
    """The least time of one call: max(FLOPs / peak, bytes / bandwidth)."""
    return max(work["flops"] / PEAK_FLOPS, work["bytes"] / PEAK_BYTES_S)


def totals(calls: list[dict], per: float) -> dict:
    """FLOPs, bytes and bound seconds of a recorded call list, divided by
    ``per`` (the member-leads or steps the calls did)."""
    flops = nbytes = bound = 0.0
    for c in calls:
        if "x_shape" in c:
            w = band_work(c["x_shape"], c["psi_shape"], c["stride"], c["nnz"])
        else:
            w = transpose_work(c["g_shape"], c["psi_shape"], c["h_in"],
                               c["stride"], c["nnz"], c["list_numel"])
        flops += c["calls"] * w["flops"]
        nbytes += c["calls"] * w["bytes"]
        bound += c["calls"] * bound_s(w)
    return {"flops": flops / per, "bytes": nbytes / per,
            "bound_s": bound / per}
