"""The port's SSD intra-chunk step and chunked scan against the JAX package.

The same numpy inputs go through the JAX Pallas kernel (interpret mode),
the JAX oracles and the port (on the CPU the port's wrapper runs its plain
version, ``kernels/ssd/ref.py``).  Bar: atol = rtol = 1e-4, the JAX
package's own bar in ``tests/test_kernels_ssd.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import few_torch_threads  # noqa: F401

from repro.kernels.ssd.ops import ssd_chunked_pallas
from repro.kernels.ssd.ref import ssd_intra_chunk_ref as jax_intra_ref
from repro.kernels.ssd.ssd import ssd_intra_chunk as jax_intra_pallas
from repro.models import ssm as jssm
from repro_torch.kernels import dispatch
from repro_torch.kernels.config import KernelConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref
from repro_torch.models import ssm as tssm

TOL = dict(atol=1e-4, rtol=1e-4)
#: (BC, L, H, P, G, N): the shapes of tests/test_kernels_ssd.py:20-26
SHAPES = [(2, 16, 4, 8, 1, 16), (3, 32, 6, 16, 2, 8), (1, 8, 2, 4, 2, 4),
          (4, 128, 8, 64, 1, 128)]


def _intra_inputs(shape, seed, scale=0.1):
    bc, l, h, p, g, n = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bc, l, h, p)).astype(np.float32)
    da = (-np.abs(rng.normal(size=(bc, l, h))) * scale).astype(np.float32)
    da_cs = np.cumsum(da, axis=1, dtype=np.float32)
    b = rng.normal(size=(bc, l, g, n)).astype(np.float32)
    c = rng.normal(size=(bc, l, g, n)).astype(np.float32)
    return x, da_cs, b, c


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_intra_chunk_matches_jax_pallas_and_oracle(shape):
    ins = _intra_inputs(shape, seed=sum(shape))
    jins = [jnp.asarray(a) for a in ins]
    yp, sp = jax_intra_pallas(*jins, n_groups=shape[4], interpret=True)
    yr, sr = jax_intra_ref(*jins)
    y_ref, s_ref = ssd_intra_chunk_ref(*_t(*ins))
    before = ssd_ops.launches
    y, s = ssd_ops.ssd_intra_chunk(*_t(*ins))
    for got in (y, y_ref):
        _close(got, yp)
        _close(got, yr)
    for got in (s, s_ref):
        _close(got, sp)
        _close(got, sr)
    assert ssd_ops.launches == before  # CPU tensors: the plain version


def test_large_decay_is_finite_and_matches_the_oracle():
    # chunk |dA| sums of ~100-160 (the mamba2-130m case: |A| up to 16,
    # dt ~ 0.1-1).  The Pallas kernel computes exp(diff) * tril, so above
    # the diagonal exp overflows and inf * 0 gives NaN there
    # (src/repro/kernels/ssd/ssd.py:54-56); the port masks before exp, as
    # the oracle does, and is held to the oracle only.
    shape = (2, 128, 4, 16, 1, 32)
    x, _, b, c = _intra_inputs(shape, seed=7)
    rng = np.random.default_rng(8)
    da = -np.abs(rng.normal(size=shape[:3])).astype(np.float32) * 1.2
    da_cs = np.cumsum(da, axis=1, dtype=np.float32)
    assert np.abs(da_cs[:, -1]).min() > 88.0
    y, s = ssd_ops.ssd_intra_chunk(*_t(x, da_cs, b, c))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    yr, sr = jax_intra_ref(*[jnp.asarray(a) for a in (x, da_cs, b, c)])
    _close(y, yr)
    _close(s, sr)


def _scan_inputs(seed, bsz=2, s=64, h=4, p=16, g=2, n=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, s, h, p)).astype(np.float32)
    da = (-np.abs(rng.normal(size=(bsz, s, h))) * 0.1).astype(np.float32)
    b = rng.normal(size=(bsz, s, g, n)).astype(np.float32)
    c = rng.normal(size=(bsz, s, g, n)).astype(np.float32)
    init = rng.normal(size=(bsz, h, p, n)).astype(np.float32)
    return x, da, b, c, init


@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
def test_chunked_kernel_path_matches_jax(with_init):
    x, da, b, c, init = _scan_inputs(seed=3)
    chunk = 16
    jin = [jnp.asarray(a) for a in (x, da, b, c)]
    jinit = jnp.asarray(init) if with_init else None
    yp, fp = ssd_chunked_pallas(*jin, chunk, initial_state=jinit,
                                interpret=True)
    yx, fx = jssm.ssd_chunked(*jin, chunk, initial_state=jinit)
    tinit = torch.from_numpy(init) if with_init else None
    for fn in (ssd_ops.ssd_chunked_kernel, tssm.ssd_chunked):
        y, f = fn(*_t(x, da, b, c), chunk, initial_state=tinit)
        for want_y, want_f in ((yp, fp), (yx, fx)):
            _close(y, want_y)
            _close(f, want_f)


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_dispatch_routes_both_paths(mode):
    x, da, b, c, _ = _scan_inputs(seed=4, s=48, g=1)
    y, f = dispatch.ssd_chunked(*_t(x, da, b, c), 16, KernelConfig(ssd=mode))
    yx, fx = jssm.ssd_chunked(*[jnp.asarray(a) for a in (x, da, b, c)], 16)
    _close(y, yx)
    _close(f, fx)


def test_chunk_recurrence_is_the_scan():
    rng = np.random.default_rng(5)
    states = torch.from_numpy(rng.normal(size=(2, 5, 3, 4, 6))
                              .astype(np.float32))
    decay = torch.from_numpy(rng.uniform(0.1, 1.0, size=(2, 5, 3))
                             .astype(np.float32))
    init = torch.from_numpy(rng.normal(size=(2, 3, 4, 6)).astype(np.float32))
    prev, final = ssd_ops.chunk_recurrence(states, decay, init)
    carry = init
    for i in range(5):
        torch.testing.assert_close(prev[:, i], carry)
        carry = carry * decay[:, i, :, None, None] + states[:, i]
    torch.testing.assert_close(final, carry)


def test_segsum_decay_and_causal_conv_match_jax():
    rng = np.random.default_rng(6)
    da_cs = np.cumsum(-np.abs(rng.normal(size=(3, 16, 4))) * 8.0, axis=1,
                      dtype=np.float32)
    got = tssm._segsum_decay(torch.from_numpy(da_cs))
    want = jssm._segsum_decay(jnp.asarray(da_cs))
    assert torch.isfinite(got).all()
    # decays below ~1e-38 are denormal in one package and flushed to 0 in
    # the other: atol covers those only
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-30)
    xbc = rng.normal(size=(2, 9, 5)).astype(np.float32)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    np.testing.assert_allclose(
        tssm._causal_conv(*_t(xbc, w, bias)).numpy(),
        np.asarray(jssm._causal_conv(*[jnp.asarray(a) for a in
                                       (xbc, w, bias)])), rtol=1e-6,
        atol=1e-6)


def test_softplus_is_jax_softplus_above_torch_threshold():
    import jax
    v = np.array([-40.0, -3.0, 0.0, 2.5, 19.0, 21.0, 35.5], np.float32)
    np.testing.assert_allclose(tssm.softplus(torch.from_numpy(v)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(v))),
                               rtol=1e-7, atol=1e-7)


def test_wrapper_refuses_bad_inputs():
    x, da_cs, b, c = _t(*_intra_inputs((1, 8, 3, 4, 1, 4), seed=9))
    with pytest.raises(TypeError, match="float32"):
        ssd_ops.ssd_intra_chunk(x.double(), da_cs, b, c)
    with pytest.raises(ValueError, match="groups"):
        ssd_ops.ssd_intra_chunk(x, da_cs, b.expand(1, 8, 2, 4),
                                c.expand(1, 8, 2, 4))
    with pytest.raises(ValueError, match="mismatch"):
        ssd_ops.ssd_intra_chunk(x, da_cs[:, :4], b, c)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_ops.ssd_chunked_kernel(x.reshape(1, 8, 3, 4), da_cs, b, c, 3)
