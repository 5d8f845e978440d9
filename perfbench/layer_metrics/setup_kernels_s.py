"""``setup_kernels_s``: host seconds of the process in loading the
kernel libraries (the ``kernels.load`` set-up spans: ``nvcc`` where the
library is not built yet, and the ``ctypes`` load)."""

from perfbench import spans


def read(ctx: dict) -> float | None:
    """Seconds, or None where the program records no such span."""
    return spans.setup_seconds("kernels.load")
