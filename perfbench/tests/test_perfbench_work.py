"""The fixed work constants: the frozen formulas of ``tools/work.py``
give back, from each configuration's recorded call list, the FLOPs,
bytes and bound seconds the configuration states (``count_work.py``
checked, when it counted, that they are the port's own formulas at the
recorded shapes)."""

import json

import pytest

from perfbench import harness
from perfbench.tools import work as frozen

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: json.loads((harness.ROOT / c["file"]).read_text())
           for c in MANIFEST["configs"]}
PARTS = [(name, part) for name, cfg in CONFIGS.items()
         for part in ("disco_forward", "disco_transpose")
         if part in cfg["work"]]


def test_every_configuration_has_its_constants():
    assert "model_flops_per_member_lead" in CONFIGS[
        "fcn3_full_forecast"]["work"]
    assert "model_flops_per_step" in CONFIGS["fcn3_full_train_stage2"]["work"]
    assert ("fcn3_full_train_stage2", "disco_transpose") in PARTS
    for cfg in CONFIGS.values():
        assert cfg["work"]["command"].startswith(
            "python3 perfbench/tools/count_work.py")


@pytest.mark.parametrize("name,part", PARTS)
def test_frozen_formulas_reproduce_the_constants(name, part):
    rec = CONFIGS[name]["work"][part]
    unit = "member_lead" if "ensemble_members" in CONFIGS[name] else "step"
    t = frozen.totals(rec["calls"], rec["per"])
    assert t["flops"] == pytest.approx(rec[f"flops_per_{unit}"], rel=1e-12)
    assert t["bytes"] == pytest.approx(rec[f"bytes_per_{unit}"], rel=1e-12)
    assert t["bound_s"] == pytest.approx(rec[f"bound_s_per_{unit}"],
                                         rel=1e-12)
