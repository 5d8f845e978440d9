"""The guards of a run: no JAX and no JAX package, no result without a
card, no result outside a checkout."""

import json
import shutil
import subprocess
import sys
import types

import pytest
import torch

from perfbench import harness

RUN = [sys.executable, str(harness.HERE / "run.py"), "--workload",
       "forecast.e4", "--seed", "1", "--seconds", "1", "--trace", "0"]


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("repro", True), ("repro.core.fcn3", True),
    ("repro_torch", False), ("repro_torch.core", False),
    ("jaxtyping", False), ("reprolib", False)])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, name, bad):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in harness.forbidden_modules()) == bad
    assert set(before) <= set(harness.forbidden_modules())


def test_the_program_and_the_harness_load_no_jax():
    code = ("import sys; sys.path[:0] = [{root!r}, {src!r}];"
            "from perfbench import harness, inputs;"
            "from perfbench.reference import fcn3;"
            "harness.mode_module('forecast'); harness.mode_module('train');"
            "import repro_torch.inference.engine, repro_torch.train.trainer;"
            "print(harness.forbidden_modules())").format(
                root=str(harness.ROOT), src=str(harness.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _no_result(out) -> bool:
    lines = out.stdout.strip().splitlines()
    if not lines:
        return True
    try:
        return "correct" not in json.loads(lines[-1])
    except json.JSONDecodeError:
        return True


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = subprocess.run(RUN, capture_output=True, text=True, timeout=300,
                         cwd=harness.ROOT)
    assert out.returncode != 0 and _no_result(out)


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = [sys.executable, str(tmp_path / "perfbench" / "run.py")] + RUN[2:]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and _no_result(out)
