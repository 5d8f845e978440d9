"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload forecast.e4 --seed 7 --seconds 45 --trace 0

from the root of a checkout, on a machine with an NVIDIA GPU.  With
``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profiled part of the window.
The last key of the line, ``checks``, holds every number that decides
``correct`` beside its limit; the same numbers end standard error.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    """Parse the arguments, run the cell, print the result; 0 on a
    result, another code where there is none."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    harness.add_program_path()
    cell = harness.load_cell(args.workload)
    import torch
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell {cell.name} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    print(f"card: {harness.card_line()}", file=sys.stderr, flush=True)
    mode = harness.mode_module(cell.mode)
    result = mode.run(cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda", t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark may not load JAX or "
              "the JAX package", file=sys.stderr)
        return 3
    harness.emit(**result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
