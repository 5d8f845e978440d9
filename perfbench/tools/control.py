"""The readings that set the limits of ``correct``, on the card at a
cell's own size, many seeds in one process: the program's (lower
readings) and the control's, the plain reference in TF32 put in the
program's place (upper readings).

    python3 perfbench/tools/control.py --workload forecast.e4 \\
        --seeds 101 102 103 --out chiprun_out/control_forecast.jsonl

One JSON line per seed: ``program`` and ``control``, each the numbers
the cell compares; a train cell adds ``one_member`` (that fault planted
in the reference), ``reordered`` (the fp32 reference with its sums in
another order), the worst leaves and every leaf's norms.  A forecast
takes the stream to its checked lead (no timed window); a train cell
takes its checked steps.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import harness  # noqa: E402


def forecast_seed(cell, seed: int, dev) -> dict:
    """One seed of a forecast cell."""
    from perfbench import device as card
    fm = harness.mode_module("forecast")
    inp = fm.make_inputs(cell, seed, dev)
    prog = fm.Program(cell, inp, seed, dev)
    blocks = []
    while inp.check_lead not in prog.captured:
        blocks.append(next(prog.stream))
    card.sync(dev)
    got = {"lead0": prog.captured[0], "prev": prog.captured[
        inp.check_lead - 1], "lead": prog.captured[inp.check_lead]}
    if cell.traffic["scored"] or cell.traffic["spectra"]:
        got["scores"] = fm.lead_scores(blocks, inp.check_lead)
    prog.close()
    del prog, blocks
    card.free(dev)
    program, control = fm.reference_readings(cell, inp, seed, got, dev,
                                             control=True)
    return {"program": program, "control": control,
            "check_lead": inp.check_lead}


def train_seed(cell, seed: int, dev) -> dict:
    """One seed of a train cell: the program's and the control's
    readings, those of the one-member fault planted in the reference,
    and those of the fp32 reference with its sums in another order."""
    from perfbench import device as card
    from perfbench import inputs
    from perfbench.reference import fcn3 as ref
    tm = harness.mode_module("train")
    c = cell.config
    cfg = ref.ModelConfig.of(c["model"])
    steps = cell.traffic["check_steps"]
    data = tm.Data(cell, cfg, seed, dev)
    prog = tm.Program(cell, cfg, seed, dev)
    losses, got = [], {}
    for i in range(steps):
        losses.append(prog.step(data.batch(i),
                                tm.noise_draws(cfg, c, seed, i, dev)))
        if i == 0:
            got["grad1"] = prog.first_gradient_norms()
    got["change"] = prog.change_norms(inputs.draw_weights(cfg, seed, dev))
    got["losses"] = [float(v) for v in losses]
    del prog
    card.free(dev)
    want = tm.reference_run(cell, cfg, seed, data, dev, steps)
    card.free(dev)
    ctl = tm.reference_run(cell, cfg, seed, data, dev, steps, control=True)
    card.free(dev)
    # the same fp32 reference with its sums in another order (smaller
    # chunks of planes): how far fp32 round-off alone moves each number
    from perfbench.reference import sphere
    kept, sphere.CHUNK_BYTES = sphere.CHUNK_BYTES, sphere.CHUNK_BYTES // 4
    try:
        other = tm.reference_run(cell, cfg, seed, data, dev, steps)
    finally:
        sphere.CHUNK_BYTES = kept
    card.free(dev)
    half = tm.reference_run(cell, cfg, seed, data, dev, steps,
                            one_member=True)
    return {"one_member": tm.readings(half, want),
            "reordered": tm.readings(other, want),
            "program": tm.readings(got, want),
            "control": tm.readings(ctl, want),
            "worst": {"program": tm.worst_leaves(got, want),
                      "control": tm.worst_leaves(ctl, want)},
            "norms": {"program": got, "reference": want,
                      "reordered": other, "control": ctl,
                      "one_member": half},
            "losses": {"program": got["losses"], "reference":
                       want["losses"], "control": ctl["losses"]}}


def main() -> int:
    """Read every seed and write one line each."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    harness.set_cache_dirs()
    harness.add_program_path()
    import torch
    from perfbench import device as card
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda")
    card.fp32_only()
    one = forecast_seed if cell.mode == "forecast" else train_seed
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for seed in args.seeds:
            t0 = time.perf_counter()
            rec = dict(one(cell, seed, dev), seed=seed, cell=cell.name,
                       seconds=time.perf_counter() - t0)
            card.free(dev)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
