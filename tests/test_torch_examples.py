"""The twins of ``examples/`` (``*_torch.py``): each runs to its last line
on the CPU (``--device cpu``; the distributed one in a world of {data 1,
model 2}), none imports JAX or the JAX package, and the storm case's
``add_vortex`` equals the JAX example's on the same numpy state (rtol
1e-6).  The JAX examples are loaded from their files and never run.
"""

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import TORCH_THREADS, few_torch_threads  # noqa: F401

from repro_torch.configs import fcn3 as tcfgs
from repro_torch.core.sphere import grids

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "storm_case_study", "distributed_training")


def _load(name: str):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_twin_imports_neither_jax_nor_the_jax_package(name):
    tree = ast.parse((ROOT / "examples" / f"{name}_torch.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    assert mods and not [m for m in mods if m == "jax"
                         or m.startswith(("jax.", "repro.")) or m == "repro"]
    assert "repro_torch.runtime" in mods


def test_quickstart_runs_to_its_last_line(capsys):
    _load("quickstart_torch").main(device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "quickstart OK"
    assert sum(ln.startswith("step ") for ln in out) == 5
    leads = [ln for ln in out if ln.startswith("lead ")]
    assert len(leads) == 4 and all("rank-hist flatness=" in ln
                                   for ln in leads)


def test_storm_case_study_runs_to_its_last_line(capsys):
    _load("storm_case_study_torch").main(device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[-1].endswith("(paper Fig. 4/5).")
    rows = [ln for ln in out if ln.rstrip().endswith(tuple("0123456789"))
            and "h   [" in ln]
    assert len(rows) == 6
    # the diagnostics callback's per-member wind maxima, 4 members a lead
    assert all(ln.count("'") == 8 for ln in rows)


def test_distributed_training_runs_to_its_last_line():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS=str(TORCH_THREADS))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples/distributed_training_torch.py"),
         "--device", "cpu", "--data", "1", "--model", "2"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = proc.stdout.splitlines()
    assert out[-1].startswith("distributed training OK")
    assert sum(ln.startswith("step ") for ln in out) == 3
    assert "rank 0: latitude rows (0, 16) of 33" in proc.stdout
    assert "rank 1: latitude rows (16, 33) of 33" in proc.stdout


@pytest.mark.parametrize("name", ("quickstart", "storm_case_study"))
def test_example_twin_needs_the_card_unless_asked_for_cpu(monkeypatch,
                                                          name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        _load(f"{name}_torch").main()


def test_add_vortex_matches_the_jax_example():
    # in float64 on both sides: in float32 the exponent's rounding (an ulp
    # of |d2| / 2r^2, up to ~80) moves the anomaly's tail by ~1e-5 of
    # itself in either package
    cfg = tcfgs.fcn3_smoke()
    grid = grids.make_grid(cfg.nlat, cfg.nlon, cfg.grid)
    state = np.random.default_rng(5).normal(
        size=(cfg.n_state, cfg.nlat, cfg.nlon))
    with jax.enable_x64(True):
        want = np.asarray(_load("storm_case_study").add_vortex(
            jnp.asarray(state), grid))
    assert want.dtype == np.float64
    got = _load("storm_case_study_torch").add_vortex(
        torch.from_numpy(state), grid).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.abs(got - state).max() > 1.0
