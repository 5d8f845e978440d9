"""The control of ``correct`` on the card, at each cell's own size: the
plain reference in TF32, put in the program's place, fails at least one
of the cell's numbers, while the program passes every one.  Run on a
machine with a card: ``python -m pytest -m cuda perfbench/tests``."""

import pytest
import torch

from perfbench import harness
from perfbench.tools import control

CELLS = ["forecast.e4", "train.stage2", "forecast.e4_scored"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32, which only "
                    "the card computes")
    harness.set_cache_dirs()
    c = harness.load_cell(cell)
    dev = torch.device("cuda")
    one = (control.forecast_seed if c.mode == "forecast"
           else control.train_seed)
    rec = one(c, 2**31 + 55, dev)
    assert all(rec["program"][k] <= v for k, v in c.limits.items()), rec
    assert any(rec["control"][k] > v for k, v in c.limits.items()), rec
