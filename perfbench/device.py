"""The card as the modes see it: synchronising, the memory peak, the
result's ``device`` record and the precision of the reference."""

from __future__ import annotations

import torch


def sync(dev: torch.device) -> None:
    """Wait for the card (nothing on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev: torch.device) -> None:
    """Start the memory peak from what is allocated now."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev: torch.device) -> int:
    """``max_memory_allocated`` since the last reset (0 on the CPU)."""
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def free(dev: torch.device) -> None:
    """Hand the allocator's cached blocks back after the program's state
    is gone, so the reference finds the card empty."""
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def record(dev: torch.device, peak: int) -> dict:
    """The result line's ``device`` for one card."""
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def fp32_only() -> None:
    """Full float32 for every product (no TF32), as the program runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class tf32:
    """TF32 on for matrix products and convolutions inside the block: the
    precision the control computes in."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32,
                    torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.old[:2]
        torch.set_float32_matmul_precision(self.old[2])


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, in ``want``'s precision."""
    got = got.to(device=want.device, dtype=want.dtype)
    return float((got - want).abs().max() / want.abs().max())


class Profiled:
    """``torch.profiler`` over CPU and CUDA while the block runs, when
    ``on``; ``trace(window_s)`` then gives the ``harness.Trace``."""

    def __init__(self, on: bool):
        self.prof = None
        if on:
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])

    def __enter__(self):
        if self.prof is not None:
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)

    def trace(self, window_s: float):
        """The stopped profile as a ``harness.Trace`` (None when off)."""
        from perfbench import harness
        return (harness.Trace.of(self.prof, window_s)
                if self.prof is not None else None)
