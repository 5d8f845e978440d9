"""The port stands alone and never runs on the CPU unless asked to.

* importing every ``repro_torch`` module loads neither ``jax`` nor any
  module of the JAX package;
* the serve and train entry points without ``--device cpu`` refuse a
  machine that has no CUDA card; with it, serve prints one line per lead
  (and writes its scores and calibration lines when asked) and train one
  line per step;
* serve takes the member counts the reference takes.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_threads import TORCH_THREADS, few_torch_threads  # noqa: F401

from repro_torch.core.fcn3 import FCN3
from repro_torch.configs import fcn3 as tcfgs
from repro_torch.runtime import resolve_device

SRC = Path(__file__).resolve().parents[1] / "src"


def _run(code: str, *args: str, timeout: int = 120):
    env = dict(os.environ, PYTHONPATH=str(SRC),
               OMP_NUM_THREADS=str(TORCH_THREADS))
    return subprocess.run([sys.executable, *args] if not code else
                          [sys.executable, "-c", code],
                          capture_output=True, text=True, env=env,
                          timeout=timeout)


def test_import_guard_no_jax_no_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) > 20, names\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_default_device_is_cuda_and_refuses_without_a_card():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        FCN3(tcfgs.fcn3_smoke())
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_serve_cli_without_device_flag_raises_on_cpu_only_machine():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = _run("", "-m", "repro_torch.launch.serve", "--config", "smoke",
                "--members", "2", "--lead-steps", "1")
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert "lead" not in proc.stdout


def test_serve_cli_on_cpu_prints_each_lead():
    proc = _run("", "-m", "repro_torch.launch.serve", "--config", "smoke",
                "--members", "2", "--lead-steps", "2", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    leads = [ln for ln in proc.stdout.splitlines() if ln.startswith("lead")]
    assert len(leads) == 2
    for ln, hours in zip(leads, ("6h", "12h")):
        assert hours in ln and "CRPS=" in ln and "ensRMSE=" in ln \
            and "SSR=" in ln


def test_serve_cli_engine_options_on_cpu(tmp_path):
    out = tmp_path / "scores.npz"
    proc = _run("", "-m", "repro_torch.launch.serve", "--config", "smoke",
                "--members", "2", "--lead-steps", "2", "--device", "cpu",
                "--precision", "bfloat16", "--perturb", "obs",
                "--calibration", "--scores-out", str(out))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len([ln for ln in lines if ln.startswith("lead")]) == 2
    assert len([ln for ln in lines if "rank-hist flatness=" in ln
                and "spectral ratio=" in ln]) == 2
    scores = np.load(out)
    assert {"crps", "rank_hist", "spectrum", "spectrum_truth"} <= set(scores)
    assert scores["spectrum"].shape == scores["spectrum_truth"].shape \
        == (2, 17, 33)


@pytest.mark.parametrize("members", [1, 3])
def test_serve_cli_member_counts_as_the_reference(members):
    # one member is the degenerate single-trajectory case the reference
    # accepts; an odd count above one cannot be antithetically centered
    proc = _run("", "-m", "repro_torch.launch.serve", "--config", "smoke",
                "--members", str(members), "--lead-steps", "1", "--device",
                "cpu")
    if members == 1:
        assert proc.returncode == 0, proc.stderr
        assert [ln for ln in proc.stdout.splitlines()
                if ln.startswith("lead")]
    else:
        assert proc.returncode == 2
        assert ("antithetic noise centering needs an even member count "
                "(members come in +/- pairs whose mean is the control); "
                "got members=3") in proc.stderr


def test_train_cli_without_device_flag_raises_on_cpu_only_machine():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = _run("", "-m", "repro_torch.launch.train", "--config", "smoke",
                "--steps", "1")
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert "step" not in proc.stdout


def test_train_cli_on_cpu_prints_each_step_and_checkpoints(tmp_path):
    proc = _run("", "-m", "repro_torch.launch.train", "--config", "smoke",
                "--steps", "2", "--device", "cpu", "--ckpt-dir",
                str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    steps = [ln for ln in proc.stdout.splitlines() if ln.startswith("step")]
    assert len(steps) == 2
    for ln in steps:
        assert all(k in ln for k in ("loss=", "nodal=", "spectral=", "|g|="))
    assert (tmp_path / "ckpt_00000002" / "arrays.npz").exists()
    assert (tmp_path / "ckpt_00000002" / "manifest.json").exists()
