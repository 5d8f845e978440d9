"""Each fault a cell can have, planted under the timed path of a run at
``fcn3_smoke`` on the CPU (the look for a card skipped), makes
``correct`` come out false."""

import pytest
import torch

from perfbench import harness
from perfbench.tests.smoke import smoke_cell

SEED = 2**31 + 4321


def unchanged_state(engine):
    step = engine.step

    def broken(params, buffers, s, z_hat, aux, eta):
        _, z = step(params, buffers, s, z_hat, aux, eta)
        return s, z
    engine.step = broken


def half_the_members(engine):
    step = engine.step

    def broken(params, buffers, s, z_hat, aux, eta):
        out, z = step(params, buffers, s, z_hat, aux, eta)
        h = out.shape[1] // 2
        return torch.cat([out[:, :h], out[:, :h]], dim=1), z
    engine.step = broken


def altered_answer(engine):
    step = engine.step

    def broken(params, buffers, s, z_hat, aux, eta):
        out, z = step(params, buffers, s, z_hat, aux, eta)
        # one latitude ring of one channel of one member off by 1 % of
        # the field's largest value
        out = out.clone()
        out[0, 0, 3, 5, :] += 0.01 * out.abs().max()
        return out, z
    engine.step = broken


def altered_score(engine):
    scores = engine.scores

    def broken(sf, truth):
        out = scores(sf, truth)
        out["crps"] = out["crps"] * 1.01
        return out
    engine.scores = broken


def params_unchanged(prog):
    opt = prog.trainer.optimizer
    prog.trainer.optimizer = type("Frozen", (), {
        "b1": opt.b1, "init": opt.init,
        "update": lambda self, params, grads, state, norm=None: {
            **state, "mu": {k: (1 - opt.b1) * g for k, g in grads.items()}}
    })()


def one_member_of_two(prog):
    fwd = prog.trainer.fwd

    def broken(buffers, s, cond):
        out = fwd(buffers, s[:1], cond[:1])
        return torch.cat([out, out])
    prog.trainer.fwd = broken


def altered_gradient(prog):
    update = prog.trainer.optimizer.update
    opt = prog.trainer.optimizer

    class Altered:
        b1 = opt.b1

        def update(self, params, grads, state, norm=None):
            grads = dict(grads)
            k = next(iter(grads))
            grads[k] = grads[k] * 1.1
            return update(params, grads, state, norm=norm)
    prog.trainer.optimizer = Altered()


@pytest.mark.parametrize("cell,fault", [
    ("forecast.e4", unchanged_state), ("forecast.e4", half_the_members),
    ("forecast.e4", altered_answer), ("forecast.e4_scored", altered_score),
    ("train.stage2", params_unchanged), ("train.stage2", one_member_of_two),
    ("train.stage2", altered_gradient)],
    ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_is_caught(cell, fault):
    c = smoke_cell(cell)
    res = harness.mode_module(c.mode).run(c, seed=SEED, seconds=0.5,
                                          trace=False, device="cpu",
                                          t0=0.0, fault=fault)
    assert not res["correct"], res["checks"]
