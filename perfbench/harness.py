"""What every mode shares: the manifest and the files it names, the
guard against the JAX package, the caches, the device, the trace and
the result line.

A cell is found by its name alone: ``BENCHMARK.json`` names its
configuration and its traffic, each a file of its own
(``configs/<config>.json``, ``traffic/<traffic>.json``), the cell's own
file ``workloads/<cell>.json`` holds the limits of ``correct``, the
traffic names the mode (``modes/<mode>.py``), and each per-layer metric
is read by ``layer_metrics/<metric>.py``.  A later cell, mode or metric
is a new file.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: the top-level module names a run may not hold: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_cache_dirs() -> None:
    """Point every build and kernel cache at a fixed directory inside the
    checkout (the port's own libraries are built in ``build/repro_torch``
    by the port itself)."""
    build = ROOT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(build / sub)


def add_program_path() -> None:
    """Make the port importable from the checkout's ``src``; a checkout
    without it cannot run the benchmark."""
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit(f"no program under {src}: the benchmark runs from "
                         "a checkout of the repository")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# The manifest and the files it names
# ---------------------------------------------------------------------------

def read_json(path: Path) -> dict:
    """A JSON file's object."""
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One cell: its entry, configuration, traffic and limits."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def mode(self) -> str:
        """The timed loop that runs it (``modes/<mode>.py``)."""
        return self.traffic["mode"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s manifest and every file it names;
    the metrics are those the cell reports."""
    manifest = read_json(root / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    config = next(c for c in manifest["configs"]
                  if c["name"] == entry["config"])

    def mine(metric):
        return name in metric.get("workloads", [name])

    return Cell(
        name=name, entry=entry, config=read_json(root / config["file"]),
        traffic=read_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=read_json(HERE / "workloads" / f"{name}.json")["limits"],
        end_to_end=[m for m in manifest["end_to_end"] if mine(m)],
        per_layer=[m for m in manifest["per_layer"] if mine(m)])


def load_module(path: Path):
    """Import one file of the benchmark by its path."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def mode_module(mode: str):
    """``modes/<mode>.py``."""
    return load_module(HERE / "modes" / f"{mode}.py")


def metric_reader(name: str):
    """``layer_metrics/<name>.py``'s ``read``."""
    return load_module(HERE / "layer_metrics" / f"{name}.py").read


# ---------------------------------------------------------------------------
# The device and the card
# ---------------------------------------------------------------------------

def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def device_record(torch, count: int, peak: int) -> dict:
    """The result line's ``device``."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trace:
    """The device and host activity of a traced window, in seconds from
    its start: ``device`` (name, start, end) of every kernel, copy and
    set on the card, ``host`` (name, start, end) of every host range."""

    window_s: float
    device: list[tuple[str, float, float]]
    host: list[tuple[str, float, float]]

    @classmethod
    def of(cls, prof, window_s: float) -> "Trace":
        """From a stopped ``torch.profiler.profile``."""
        from torch.autograd import DeviceType
        dev, host = [], []
        events = list(prof.profiler.kineto_results.events())
        t0 = min(e.start_ns() for e in events) if events else 0

        def annotation(e) -> bool:
            return bool(getattr(e, "is_user_annotation", lambda: False)())

        # a host range (record_function) is mirrored on the device's
        # timeline; it is no work of the card's
        ranges = {e.name() for e in events if annotation(e)}
        for e in events:
            rec = (e.name(), (e.start_ns() - t0) * 1e-9,
                   (e.start_ns() + e.duration_ns() - t0) * 1e-9)
            if e.device_type() != DeviceType.CUDA:
                host.append(rec)
            elif not annotation(e) and e.name() not in ranges:
                dev.append(rec)
        return cls(window_s, sorted(dev, key=lambda r: r[1]),
                   sorted(host, key=lambda r: r[1]))

    def busy_s(self) -> float:
        """Seconds in which anything ran on the card: the union of the
        intervals of every stream, overlaps counted once."""
        return sum(b - a for a, b in self._merged())

    def _merged(self) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for _, a, b in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [tuple(x) for x in out]

    def kernel_s(self, match) -> float:
        """Summed duration of the device events whose name ``match``
        accepts."""
        return sum(b - a for n, a, b in self.device if match(n))

    def top_ops(self, n: int = 10) -> list[list]:
        """The ``n`` device operations with the most time, summed by name."""
        tot: dict[str, float] = {}
        for name, a, b in self.device:
            tot[name] = tot.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The ``n`` longest gaps between device activity, each named by
        the innermost host range open at its middle."""
        merged = self._merged()
        gaps = sorted(((b0, a1) for (_, b0), (a1, _) in
                       zip(merged, merged[1:])), key=lambda g: g[0] - g[1])
        starts = [h[1] for h in self.host]
        out = []
        for a, b in gaps[:n]:
            mid = 0.5 * (a + b)
            open_ = [h for h in self.host[:bisect.bisect_right(starts, mid)]
                     if h[2] >= mid]
            name = (min(open_, key=lambda h: h[2] - h[1])[0] if open_
                    else "no host range")
            out.append([name, b - a])
        return out


# ---------------------------------------------------------------------------
# The result
# ---------------------------------------------------------------------------

def judge(readings: dict[str, float], limits: dict[str, float]
          ) -> tuple[bool, dict]:
    """Each number that has a limit beside it; correct when every one of
    them is finite and within its limit (a number without a limit is
    not compared)."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = readings[name]
        good = math.isfinite(value) and value <= limit
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def result(cell: Cell, *, correct: bool, attempted: int, failed: int,
           checks: dict, device: dict, values: dict | None = None,
           traced: Trace | None = None, work: dict | None = None) -> dict:
    """``emit``'s arguments for one run: the cell's end-to-end metrics
    from ``values`` (an untraced run), or its per-layer metrics read from
    ``traced`` with the window's ``work`` (a traced run), which also adds
    the device's busy and window seconds and the breakdown.  A metric
    that is not finite makes the run not correct."""
    breakdown = None
    if traced is None:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        ctx = {"trace": traced, "config": cell.config, "work": work}
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device = dict(device, busy_s=traced.busy_s(),
                      window_s=traced.window_s)
        breakdown = {"device_ops": traced.top_ops(),
                     "idle_gaps": traced.idle_gaps()}
    if not all(math.isfinite(m["value"]) for m in metrics.values()):
        correct = False
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device, "checks": checks,
            "breakdown": breakdown}


def emit(correct: bool, attempted: int, failed: int, metrics: dict,
         device: dict, checks: dict, breakdown: dict | None = None) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output, its checks last."""
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    print(json.dumps(line), flush=True)
