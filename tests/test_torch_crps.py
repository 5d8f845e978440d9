"""The port's CRPS kernel wrappers (plain versions on the CPU), their
backward, ``crps_sorted`` and the FCN3 objective against the JAX package.

Forward values are held to the JAX Pallas kernel (interpret mode) and its
oracle at the bar of ``tests/test_kernels.py`` (1e-5); gradients to
``jax.grad`` of the oracle on inputs without ties.  At ties the two
packages differ by design: torch's ``abs`` has gradient 0 at 0, JAX's 1,
and the port's kernel follows torch (sgn(0) = 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import few_torch_threads  # noqa: F401

from repro.core import crps as jcrps
from repro.core.sphere import grids as jgrids
from repro.core.sphere import sht as jsht
from repro.kernels.crps.crps import crps_fused as j_crps_pallas
from repro.kernels.crps.ops import crps_pointwise_pallas, nodal_crps_pallas
from repro.kernels.crps.ref import crps_fused_ref as j_crps_ref
from repro_torch.core import crps as tcrps
from repro_torch.core.sphere import grids as tgrids
from repro_torch.core.sphere import sht as tsht
from repro_torch.kernels.crps import ops as crps_ops
from repro_torch.kernels.crps.ref import crps_fused_bwd_ref


def _ens(e, n, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((e, n)).astype(np.float32),
            r.standard_normal((n,)).astype(np.float32))


class TestForward:
    @pytest.mark.parametrize("e,n,fair", [
        (1, 100, False), (2, 1000, False), (2, 1000, True), (3, 777, True),
        (8, 100, False), (16, 1000, True)])
    def test_plain_matches_pallas_and_oracle(self, e, n, fair):
        ens, obs = _ens(e, n, e * 31 + n)
        got = crps_ops.crps_fused(torch.from_numpy(ens),
                                  torch.from_numpy(obs), fair).numpy()
        je, jo = jnp.asarray(ens), jnp.asarray(obs)
        np.testing.assert_allclose(
            got, np.asarray(j_crps_pallas(je, jo, fair=fair, interpret=True)),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            got, np.asarray(j_crps_ref(je, jo, fair=fair)),
            rtol=1e-5, atol=1e-5)

    def test_pointwise_and_nodal_match_pallas_wrappers(self):
        r = np.random.default_rng(1)
        ens = r.standard_normal((4, 2, 3, 8, 16)).astype(np.float32)
        obs = r.standard_normal((2, 3, 8, 16)).astype(np.float32)
        aw = r.random((8, 16)).astype(np.float32)
        aw /= aw.sum()
        got = crps_ops.crps_pointwise(torch.from_numpy(ens),
                                      torch.from_numpy(obs), fair=True)
        assert got.shape == (2, 3, 8, 16)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(crps_pointwise_pallas(
                jnp.asarray(ens), jnp.asarray(obs), fair=True,
                interpret=True)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            tcrps.nodal_crps_loss(torch.from_numpy(ens),
                                  torch.from_numpy(obs),
                                  torch.from_numpy(aw)).numpy(),
            np.asarray(nodal_crps_pallas(jnp.asarray(ens), jnp.asarray(obs),
                                         jnp.asarray(aw), interpret=True)),
            rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("e", [2, 5, 8])
    def test_crps_sorted_matches_jax_and_pairwise(self, e):
        ens, obs = _ens(e, 500, e)
        got = tcrps.crps_sorted(torch.from_numpy(ens), torch.from_numpy(obs))
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jcrps.crps_sorted(jnp.asarray(ens),
                                                      jnp.asarray(obs))),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            got.numpy(), tcrps.crps_pairwise(torch.from_numpy(ens),
                                             torch.from_numpy(obs)).numpy(),
            rtol=1e-5, atol=1e-6)


class TestBackward:
    @pytest.mark.parametrize("e,fair", [(2, False), (2, True), (4, True),
                                        (16, False)])
    def test_plain_backward_matches_jax_grad(self, e, fair):
        ens, obs = _ens(e, 300, 100 + e)
        g = np.random.default_rng(e).standard_normal(300).astype(np.float32)
        want = jax.grad(lambda a: jnp.sum(jnp.asarray(g) * j_crps_ref(
            a, jnp.asarray(obs), fair=fair)))(jnp.asarray(ens))
        got = crps_fused_bwd_ref(torch.from_numpy(g), torch.from_numpy(ens),
                                 torch.from_numpy(obs), fair)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
        # and through the autograd function the objective uses
        et = torch.from_numpy(ens).requires_grad_()
        (auto,) = torch.autograd.grad(
            crps_ops.crps_pointwise(et, torch.from_numpy(obs), fair), et,
            torch.from_numpy(g))
        np.testing.assert_allclose(auto.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)

    def test_ties_take_sgn0_zero(self):
        # members tied with each other and with the observation: the port
        # takes sgn(0) = 0 (torch's abs); JAX's abs has gradient 1 at 0,
        # so at an observation tie the two differ by design
        ens = torch.tensor([[1.0, 2.0, 0.0], [1.0, 2.0, 3.0]])
        obs = torch.tensor([0.0, 2.0, -1.0])
        g = torch.ones(3)
        got = crps_ops.crps_fused_bwd(g, ens, obs, fair=True)
        # point 0: members tied, both above obs -> 1/E each
        # point 1: everything tied -> 0
        # point 2: u = (0, 3) > y; pair term c/E^2 * (-1, +1), c = 2
        want = torch.tensor([[0.5, 0.0, 0.5 + 0.5], [0.5, 0.0, 0.5 - 0.5]])
        torch.testing.assert_close(got, want)
        et = ens.clone().requires_grad_()
        (auto,) = torch.autograd.grad(
            tcrps.crps_fair(et, obs).sum(), et)
        torch.testing.assert_close(auto, want)
        jgrad = jax.grad(lambda a: jnp.sum(j_crps_ref(
            a, jnp.asarray(obs.numpy()), fair=True)))(jnp.asarray(ens.numpy()))
        # the pair terms cancel in JAX too; the observation tie does not
        np.testing.assert_allclose(np.asarray(jgrad)[:, [0, 2]],
                                   want.numpy()[:, [0, 2]])
        np.testing.assert_allclose(np.asarray(jgrad)[:, 1], [0.5, 0.5])

    def test_no_gradient_for_observations(self):
        ens, obs = _ens(2, 50, 3)
        et = torch.from_numpy(ens).requires_grad_()
        ot = torch.from_numpy(obs).requires_grad_()
        crps_ops.crps_pointwise(et, ot).sum().backward()
        assert et.grad is not None and ot.grad is None


class TestObjective:
    @pytest.fixture(scope="class")
    def case(self):
        r = np.random.default_rng(5)
        grid = (33, 64, "equiangular")
        ens = r.standard_normal((2, 2, 5, 33, 64)).astype(np.float32)
        obs = r.standard_normal((2, 5, 33, 64)).astype(np.float32)
        cw = r.random(5).astype(np.float32) + 0.1
        jg = jgrids.make_grid(*grid)
        wpct = jsht.SHT.create(jg).buffers()["wpct"]
        aw = jg.area_weights_2d().astype(np.float32)
        tw = torch.from_numpy(np.asarray(tsht.SHT.create(
            tgrids.make_grid(*grid)).buffers()["wpct"]))
        return ens, obs, cw, wpct, aw, tw

    @pytest.mark.parametrize("fair", [False, True])
    def test_objective_and_gradient_match_jax(self, case, fair):
        ens, obs, cw, wpct, aw, tw = case

        def jloss(a):
            return jcrps.fcn3_objective(a, jnp.asarray(obs), jnp.asarray(aw),
                                        wpct, jnp.asarray(cw), 0.7, fair)

        (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(
            jnp.asarray(ens))
        et = torch.from_numpy(ens).requires_grad_()
        loss, aux = tcrps.fcn3_objective(
            et, torch.from_numpy(obs), torch.from_numpy(aw), tw,
            torch.from_numpy(cw), 0.7, fair)
        (grad,) = torch.autograd.grad(loss, et)
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
        for k in ("nodal", "spectral"):
            np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                       rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(grad.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-8)

    def test_spectral_term_matches_jax_per_channel(self, case):
        ens, obs, _, wpct, _, tw = case
        want = jcrps.spectral_crps_loss(jnp.asarray(ens), jnp.asarray(obs),
                                        wpct, fair=True)
        got = tcrps.spectral_crps_loss(torch.from_numpy(ens),
                                       torch.from_numpy(obs), tw, fair=True)
        assert got.shape == (2, 5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-7)
