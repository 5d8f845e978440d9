"""Where a traced window's time goes in the program: one cell run as
``run.py --trace 1`` runs it, its result line printed as ``run.py``
prints it, then one JSON line with the ``n`` longest idle gaps of the
card, each under the innermost span of the program open at its middle
(the profiler's ranges of ``repro_torch.telemetry``'s spans, on the
profiler's clock), and each span name's host seconds, device
milliseconds and count.

    python3 perfbench/tools/gaps.py --workload forecast.e4_scored \\
        --seed 7 --out chiprun_out/gaps_scored.json
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import harness  # noqa: E402


def program_gaps(trace: harness.Trace, names: set[str], n: int = 10
                 ) -> list[list]:
    """The ``n`` longest gaps between device activity, each named by the
    innermost host range open at its middle whose name is in ``names``
    (``"no program span"`` where none is)."""
    merged = trace._merged()
    gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])),
                  key=lambda g: g[0] - g[1])
    host = [h for h in trace.host if h[0] in names]
    starts = [h[1] for h in host]
    out = []
    for a, b in gaps[:n]:
        mid = 0.5 * (a + b)
        open_ = [h for h in host[:bisect.bisect_right(starts, mid)]
                 if h[2] >= mid]
        name = (min(open_, key=lambda h: h[2] - h[1])[0] if open_
                else "no program span")
        out.append([name, b - a])
    return out


def span_totals(spans: list[dict]) -> dict[str, dict]:
    """Each span name's summed host seconds and device ms, and count."""
    out: dict[str, dict] = {}
    for s in spans:
        t = out.setdefault(s["name"], {"host_s": 0.0, "device_ms": 0.0,
                                       "count": 0})
        t["count"] += 1
        t["host_s"] += s["dur_s"] or 0.0
        t["device_ms"] += s["device_ms"] or 0.0
    return out


def main(argv: list[str] | None = None) -> int:
    """Run the cell traced and print its result and its gaps."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--gaps", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the gaps here")
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    harness.add_program_path()
    from repro_torch import telemetry
    cell = harness.load_cell(args.workload)
    seen = {}
    result = harness.result

    def capture(c, **kw):
        seen["trace"] = kw["traced"]
        seen["spans"] = telemetry.process_spans()
        return result(c, **kw)

    harness.result = capture
    print(f"card: {harness.card_line()}", file=sys.stderr, flush=True)
    res = harness.mode_module(cell.mode).run(
        cell, seed=args.seed, seconds=1.0, trace=True, device="cuda", t0=T0)
    harness.emit(**res)
    hot = {s["name"] for s in seen["spans"] if s["device_ms"] is not None}
    out = {"workload": cell.name, "seed": args.seed,
           "window_s": seen["trace"].window_s,
           "busy_s": seen["trace"].busy_s(),
           "program_gaps": program_gaps(seen["trace"], hot, args.gaps),
           "spans": span_totals(seen["spans"]),
           "dropped": telemetry.process_trace().dropped}
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
