"""The port's WB2 evaluation CLI (``repro_torch.launch.evaluate``) against
the JAX package's ``repro.launch.evaluate`` on ``fcn3_smoke``.

Both ``main``s run in this process from one reference checkpoint
(``--ckpt``): the reference's with its own threefry draws, the port's
with those draws injected (``noises``) and the reference dataset's
fields handed in (``data``), since neither stream can be reproduced in
torch.  2 initial conditions x 2 leads x 4 members; every entry of the
JSON tables is held at rtol 1e-4 / atol 1e-6, the dispatch bar of the
scores (``tests/test_kernel_dispatch.py:289``).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from _torch_threads import few_torch_threads  # noqa: F401

from repro.configs import fcn3 as jcfgs
from repro.core.fcn3 import FCN3 as JFCN3
from repro.data import era5_synthetic as jdata
from repro.launch import evaluate as jeval
from repro.train import checkpoint as jckpt
from repro_torch.inference.engine import InjectedNoise
from repro_torch.launch import evaluate as teval

MEMBERS, LEADS, ICS, SEED = 4, 2, 2, 3


class ReferenceData:
    """The reference dataset's fields as torch tensors."""

    def __init__(self, ds):
        self.ds = ds

    def state(self, sample: int, offset: int = 0) -> torch.Tensor:
        return torch.from_numpy(np.array(self.ds.state(sample, offset)))

    def aux_fields(self, t_hours: float) -> torch.Tensor:
        return torch.from_numpy(np.array(self.ds.aux_fields(t_hours)))


def _argv(ckpt, out):
    return ["--config", "smoke", "--members", str(MEMBERS), "--lead-steps",
            str(LEADS), "--initial-conditions", str(ICS), "--ckpt", ckpt,
            "--out-json", out, "--seed", str(SEED)]


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """The reference's JSON and the port's, from one checkpoint."""
    d = tmp_path_factory.mktemp("evaluate")
    cfg = jcfgs.fcn3_smoke()
    model = JFCN3(cfg)
    ckpt = jckpt.save_checkpoint(str(d), 0,
                                 model.init(jax.random.PRNGKey(0)))
    argv = sys.argv
    sys.argv = ["evaluate"] + _argv(ckpt, str(d / "ref.json"))
    try:
        jeval.main()
    finally:
        sys.argv = argv
    nb = model.noise.buffers()

    def noises(ic):
        # the reference's draws: fold_in(PRNGKey(seed), ic) for z_hat,
        # fold_in(PRNGKey(7), 100 ic + lead) for each lead's eta
        z0 = model.noise.init_state(
            jax.random.fold_in(jax.random.PRNGKey(SEED), ic), (MEMBERS,),
            nb)
        etas = [np.asarray(model.noise._sample_coeffs(
            jax.random.fold_in(jax.random.PRNGKey(7), ic * 100 + lead),
            (MEMBERS,), nb["sigma_l"])) for lead in range(LEADS)]
        return InjectedNoise(np.asarray(z0), etas)

    lines = []
    got = teval.main(_argv(ckpt, str(d / "port.json")) + ["--device", "cpu"],
                     noises=noises, data=ReferenceData(jdata.SyntheticERA5(
                         cfg)), report=lines.append)
    with open(d / "ref.json") as f:
        ref = json.load(f)
    with open(d / "port.json") as f:
        port = json.load(f)
    return ref, port, got, lines


def test_json_layout_is_the_references(tables):
    ref, port, got, _ = tables
    assert port["channels"] == ref["channels"]
    assert port["headline"] == ref["headline"]
    assert set(port["results"]) == set(ref["results"]) == {
        f"lead_{6 * (n + 1)}h" for n in range(LEADS)}
    assert got == port["results"]
    for lead, metrics in ref["results"].items():
        assert set(port["results"][lead]) == set(metrics) == {
            "crps", "rmse_ens_mean", "acc", "ssr", "psd_ratio", "rank_hist"}


@pytest.mark.parametrize("metric", ["crps", "rmse_ens_mean", "acc", "ssr",
                                    "psd_ratio", "rank_hist"])
def test_tables_match_the_reference(tables, metric):
    ref, port, _, _ = tables
    for lead in ref["results"]:
        want = np.asarray(ref["results"][lead][metric])
        have = np.asarray(port["results"][lead][metric])
        assert have.shape == want.shape
        assert np.isfinite(have).all()
        np.testing.assert_allclose(have, want, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{lead} {metric}")


def test_csv_lines_per_lead_and_metric(tables):
    _, port, _, lines = tables
    rows = [ln for ln in lines if ln[:1].isdigit()]
    assert len(rows) == LEADS * 5
    assert rows[0].startswith("6,crps,")
    assert len(rows[0].split(",")) == 2 + len(port["headline"])


def test_online_scores_match_the_reference():
    r = np.random.default_rng(0)
    ours, theirs = teval.OnlineScores(3), jeval.OnlineScores(3)
    for _ in range(3):
        scores = {"crps": r.random(5), "acc": r.random(5)}
        hist = r.random(4)
        ours.update(scores, hist)
        theirs.update(scores, hist)
    a, b = ours.means(), theirs.means()
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert teval.HEADLINE == jeval.HEADLINE


def test_without_a_card_it_refuses():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        teval.main(["--config", "smoke"])


def test_evaluate_imports_no_jax():
    code = ("import sys; import repro_torch.launch.evaluate; "
            "print('jax' in sys.modules, 'repro' in sys.modules)")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, check=True)
    assert out.stdout.split() == ["False", "False"]
