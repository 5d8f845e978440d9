"""Count a configuration's fixed work constants once, with the port's dry
run on fake tensors (``repro_torch.launch.dryrun``: kernels by their own
``work``, aten ops by ``FlopCounterMode``), and write them as the
``work`` group of the configuration files.

    python3 perfbench/tools/count_work.py --out chiprun_out/work.json

It builds the full-width geometry plans on the host (about 20 s and a
few GB), so it runs where the benchmark runs, never at run time: each
group of its output is the ``work`` group of the configuration file of
that name, which the benchmark reads.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from perfbench.tools import work as frozen  # noqa: E402

COMMAND = "python3 perfbench/tools/count_work.py --out chiprun_out/work.json"


def count(shape: str, sizes: tuple[int, int, int], tcfg=None):
    """The counts of one FCN3 case at ``fcn3_full`` in one process."""
    from repro_torch.configs import fcn3 as fcn3cfg
    from repro_torch.launch import counting, dryrun
    from repro_torch.launch import roofline as roof
    with counting.DryRun(counting.dry_run_device()) as dry:
        case = dryrun.build_fcn3_case(shape, None, dry,
                                      cfg=fcn3cfg.fcn3_full(), sizes=sizes,
                                      tcfg=tcfg)
        _, counts = roof.analyze(shape, case.step, case.args, 1,
                                 case.model_flops, dry)
    return counts


def call_list(counts, family: str) -> list[dict]:
    """The recorded calls of one kernel family with the operands the
    frozen formulas take (``nnz`` and ``list_numel`` read back from the
    counted FLOPs and bytes)."""
    out = []
    for (fam, key), (n, flops, nbytes) in sorted(counts.kernel_calls.items()):
        if fam != family:
            continue
        if family == "disco_band_contract":
            x, psi, stride = key
            w_out = x[2] // stride
            nnz = round(flops / n / (2.0 * w_out * x[0]))
            out.append({"x_shape": list(x), "psi_shape": list(psi),
                        "stride": stride, "nnz": nnz, "calls": n})
        else:
            g, psi, h_in, stride = key
            nnz = round(flops / n / (2.0 * g[3] * g[0]))
            rest = (nbytes / n / 4.0 - g[0] * g[1] * g[2] * g[3]
                    - g[0] * h_in * g[3] * stride)
            out.append({"g_shape": list(g), "psi_shape": list(psi),
                        "h_in": h_in, "stride": stride, "nnz": nnz,
                        "list_numel": round(rest), "calls": n})
        c = out[-1]
        w = (frozen.band_work(c["x_shape"], psi, stride, c["nnz"])
             if "x_shape" in c else
             frozen.transpose_work(c["g_shape"], psi, h_in, stride, c["nnz"],
                                   c["list_numel"]))
        if abs(w["flops"] * n - flops) > 1e-6 * flops or \
                abs(w["bytes"] * n - nbytes) > 1e-6 * nbytes:
            raise SystemExit(f"the frozen formula does not give {family}"
                             f" {key}'s count: {w} x {n} vs {flops, nbytes}")
    return out


def main() -> int:
    """Count both configurations and write their ``work`` groups."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    from repro_torch.train.trainer import TrainConfig
    fc = json.load(open(ROOT / "perfbench/configs/fcn3_full_forecast.json"))
    tc = json.load(open(ROOT / "perfbench/configs/"
                        "fcn3_full_train_stage2.json"))
    e = fc["ensemble_members"]
    fwd = count("inference", (1, e, 1))
    calls = call_list(fwd, "disco_band_contract")
    t = frozen.totals(calls, e)
    forecast = {
        "command": COMMAND,
        "counted": ("repro_torch.launch.dryrun.build_fcn3_case('inference', "
                    f"sizes=(1, {e}, 1)) on fake tensors: one forward of "
                    f"{e} members"),
        "model_flops_per_member_lead": (fwd.kernel_flops + fwd.aten_flops)
        / e,
        "disco_forward": {"calls": calls, "per": e,
                          "flops_per_member_lead": t["flops"],
                          "bytes_per_member_lead": t["bytes"],
                          "bound_s_per_member_lead": t["bound_s"]}}
    te, tb = tc["ensemble_size"], tc["batch_size"]
    fwd2 = count("inference", (tb, te, 1))
    step = count("train", (tb, te, tc["rollout_steps"]), TrainConfig(
        ensemble_size=te, rollout_steps=tc["rollout_steps"],
        fair_crps=tc["fair_crps"], lr=tc["lr"],
        lr_halve_every=tc["lr_halve_every"], clip_norm=tc["clip_norm"]))
    fcalls = call_list(step, "disco_band_contract")
    tcalls = call_list(step, "disco_band_transpose")
    tf, tt = frozen.totals(fcalls, 1), frozen.totals(tcalls, 1)
    train = {
        "command": COMMAND,
        "counted": ("build_fcn3_case('train', sizes=(1, 2, 1)): one train "
                    "step (forward, the blocks' recomputation, backward, "
                    "CRPS, Adam); the model FLOPs are three times the "
                    "counted forward of its members, "
                    "build_fcn3_case('inference', sizes=(1, 2, 1))"),
        "model_flops_per_step": 3.0 * (fwd2.kernel_flops
                                       + fwd2.aten_flops)
        * tc["rollout_steps"],
        "executed_flops_per_step": step.kernel_flops + step.aten_flops,
        "disco_forward": {"calls": fcalls, "per": 1,
                          "flops_per_step": tf["flops"],
                          "bytes_per_step": tf["bytes"],
                          "bound_s_per_step": tf["bound_s"]},
        "disco_transpose": {"calls": tcalls, "per": 1,
                            "flops_per_step": tt["flops"],
                            "bytes_per_step": tt["bytes"],
                            "bound_s_per_step": tt["bound_s"]}}
    out = {"fcn3_full_forecast": forecast, "fcn3_full_train_stage2": train}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: {kk: vv for kk, vv in v.items()
                          if not isinstance(vv, dict)}
                      for k, v in out.items()}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
