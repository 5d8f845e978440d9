"""Tune the port's kernel tiles on the card: the counterpart of the JAX
package's ``repro.launch.tune``.

Sweeps the candidate tiles of each kernel family (``kernels.autotune``)
at concrete shapes -- derived from a named FCN3 config or given
explicitly -- and persists the winners in a ``TuningCache`` directory.
A second run over the same shapes reports ``sweeps=0``: everything
resolves from the cache.  Serve with the winners through
``repro_torch.launch.service --tuning-dir``, or pack them into a
warm-start bundle (``repro_torch.launch.bundle build --tuning-dir``).

Tune ``fcn3_full``'s families (``autotune.model_op_shapes``)::

  PYTHONPATH=src python -m repro_torch.launch.tune --config full \\
      --tuning-dir .tuning

Explicit shapes (CSV fields per op; see
``repro_torch.kernels.autotune.OP_SHAPE_FIELDS``), here the
``mamba2-130m`` prefill's SSD shape (``autotune.lm_op_shapes``)::

  PYTHONPATH=src python -m repro_torch.launch.tune --tuning-dir .tuning \\
      --op ssd --shape 512,128,24,64,1,128 --op crps --shape 2,74753280

Every tuned op prints one CSV row
(``op,shapes,swept,candidates,default_us,best_us,speedup,blocks``); the
final line is the summary (``sweeps=N entries=M dir=...``).  Tuning
needs a CUDA card: ``--device cpu`` is refused, since the CPU runs the
plain versions, whatever the tile.
"""

from __future__ import annotations

import argparse

#: the CSV header, one row per op after it
HEADER = "op,shapes,swept,candidates,default_us,best_us,speedup,blocks"


def model_shapes(config: str, members: int, device="cuda") -> dict:
    """``autotune.model_op_shapes`` of the named FCN3 config, its model
    built on ``device``."""
    from repro_torch.configs import fcn3 as fcn3cfg
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.kernels import autotune
    model = FCN3(fcn3cfg.NAMED_CONFIGS[config](), device=device)
    return autotune.model_op_shapes(model, members=members)


def run(ops_shapes: dict, cache, *, max_candidates: int | None = 8,
        iters: int = 5, force: bool = False, timer=None, runners=None,
        device="cuda", out=print) -> list[dict]:
    """Sweep every ``op -> shapes`` of ``ops_shapes`` into ``cache``,
    printing the CSV header, one row per op and the summary line through
    ``out``; returns the entries (each with ``swept``).

    Timing on the card (no ``timer``), the candidates' libraries of every
    op still to sweep are built first, all in parallel.  ``runners`` maps
    an op to its ``OpRunner`` (by default ``sweep_op`` makes one).
    """
    from repro_torch.kernels import autotune, build
    runners = runners or {}
    if timer is None:
        todo = [(op, shapes) for op, shapes in ops_shapes.items()
                if force or cache.get(op, shapes) is None]
        build.build_all([autotune.library_for(op, d) for op, shapes in todo
                         for d in autotune.candidates(op, shapes,
                                                      max_candidates)])
    out(HEADER)
    entries, sweeps = [], 0
    for op, shapes in ops_shapes.items():
        entry = autotune.sweep_op(
            op, shapes, cache=cache, force=force, timer=timer,
            runner=runners.get(op), max_candidates=max_candidates,
            iters=iters, device=device)
        sweeps += entry["swept"]
        speedup = entry["default_us"] / max(entry["best_us"], 1e-9)
        out(f"{op},{'x'.join(str(v) for v in shapes)},"
            f"{int(entry['swept'])},{len(entry['candidates'])},"
            f"{entry['default_us']:.1f},{entry['best_us']:.1f},"
            f"{speedup:.2f}x,{autotune.format_blocks(op, entry['dims'])}")
        entries.append(entry)
    stats = cache.stats()
    out(f"sweeps={sweeps} entries={stats['entries']} dir={stats['dir']}")
    return entries


def build_parser() -> argparse.ArgumentParser:
    """The CLI's flags: the JAX package's, plus ``--device``."""
    from repro_torch.configs import fcn3 as fcn3cfg
    from repro_torch.kernels import autotune
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="full",
                    choices=sorted(fcn3cfg.NAMED_CONFIGS),
                    help="named FCN3 config to derive op shapes from "
                         "(ignored when --op/--shape pairs are given)")
    ap.add_argument("--members", type=int, default=2,
                    help="ensemble size the derived shapes assume")
    ap.add_argument("--op", action="append", default=[],
                    choices=sorted(autotune.OP_SHAPE_FIELDS),
                    help="tune this op at the matching --shape (repeat "
                         "both, in order, to tune several)")
    ap.add_argument("--shape", action="append", default=[], metavar="CSV",
                    help="comma-separated shape for the matching --op, "
                         "e.g. 1354,360,360,360 for legendre (b,k,n,m)")
    ap.add_argument("--tuning-dir", default=".tuning",
                    help="TuningCache directory the winners persist in")
    ap.add_argument("--max-candidates", type=int, default=8,
                    help="cap on swept tiles per op (the committed tile "
                         "is always included)")
    ap.add_argument("--iters", type=int, default=5,
                    help="timed calls per candidate (their median)")
    ap.add_argument("--force", action="store_true",
                    help="sweep again even when the cache holds an entry "
                         "for (op, shapes, dtype, card, versions, source)")
    ap.add_argument("--device", default="cuda",
                    help="the card to tune on; 'cpu' is refused (the "
                         "plain versions run there, whatever the tile)")
    return ap


def main(argv=None, timer=None) -> None:
    """Run the tune CLI; ``timer`` replaces the card's (tests)."""
    from repro_torch.kernels import autotune
    ap = build_parser()
    args = ap.parse_args(argv)
    if len(args.op) != len(args.shape):
        ap.error(f"got {len(args.op)} --op but {len(args.shape)} --shape; "
                 "they pair up in order")
    if args.device.split(":")[0] != "cuda":
        ap.error(f"--device {args.device}: tuning times the CUDA kernels "
                 "on a card; on the CPU the plain versions run, whatever "
                 "the tile, so there is nothing to tune")
    if timer is None:
        import torch
        if not torch.cuda.is_available():
            ap.error("no CUDA card: the tiles are timed on the card")
    if args.op:
        ops_shapes = {}
        for op, raw in zip(args.op, args.shape):
            try:
                ops_shapes[op] = tuple(int(v) for v in raw.split(","))
            except ValueError:
                ap.error(f"--shape {raw!r} is not a comma-separated "
                         "integer list")
    else:
        ops_shapes = model_shapes(args.config, args.members, args.device)
    run(ops_shapes, autotune.TuningCache(args.tuning_dir),
        max_candidates=args.max_candidates, iters=args.iters,
        force=args.force, timer=timer, device=args.device)


if __name__ == "__main__":
    main()
