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
from repro_torch.kernels.ssd.ref import (chunk_recurrence_ref,
                                         ssd_intra_chunk_ref)
from repro_torch.models import ssm as tssm
from test_torch_cuda import GRAD_ATOL, GRAD_RTOL, SSD_BWD_SHAPES, SSD_SHAPES

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


@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
def test_plain_chunk_recurrence_matches_the_jax_scan(with_init):
    # the recurrence's plain version against the jax.lax.scan inside the
    # JAX package's ssd_chunked_pallas (its intra-chunk step in interpret
    # mode): the state entering chunk c is that scan's final state over
    # the first c chunks, and the final state its final state over all
    x, da, b, c, init = _scan_inputs(seed=12, s=64)
    chunk, nc = 16, 4
    bsz, _, h, p = x.shape
    g, n = b.shape[2:]
    jinit = jnp.asarray(init) if with_init else None

    def chunks(a, tail):
        return torch.from_numpy(a).reshape((bsz * nc, chunk) + tail)

    da_cs = torch.cumsum(chunks(da, (h,)), dim=1)
    _, states = ssd_intra_chunk_ref(chunks(x, (h, p)), da_cs,
                                    chunks(b, (g, n)), chunks(c, (g, n)))
    tinit = (torch.from_numpy(init) if with_init
             else torch.zeros((bsz, h, p, n)))
    prev, final = ssd_ops.chunk_recurrence(
        states.reshape(bsz, nc, h, p, n),
        torch.exp(da_cs[:, -1]).reshape(bsz, nc, h), tinit)
    torch.testing.assert_close(prev[:, 0], tinit)
    for k in range(1, nc + 1):
        jin = [jnp.asarray(a[:, :k * chunk]) for a in (x, da, b, c)]
        _, want = ssd_chunked_pallas(*jin, chunk, initial_state=jinit,
                                     interpret=True)
        _close(prev[:, k] if k < nc else final, want)
    np.testing.assert_array_equal(
        final.numpy(), chunk_recurrence_ref(
            states.reshape(bsz, nc, h, p, n),
            torch.exp(da_cs[:, -1]).reshape(bsz, nc, h), tinit)[1].numpy())


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


def _emulate_ssd(x, da_cs, b, c, heads=24, skip=None, read_above=False):
    """csrc/ssd.cu's tile walk in numpy, block by block: (chunk, group,
    tile of ``heads`` heads); C B^T of the group formed once, only its
    causal 16 x 8 tiles (l-tile i, s-tile j <= 2 i + 1), stored per lane
    in the A-fragment order of att @ X (c0, c2, c1, c3 of lane 4 g + t);
    then per head, in order, y over each l-tile's s-blocks up to its
    diagonal with the decay masked before exp, and the state over
    k-blocks of 8 with X's rows scaled by exp(cs[L-1] - cs[l]).  Within a
    k-block the depth runs over s (or l) as 0 2 4 6 | 1 3 5 7.  Returns
    (y, states, the tiles formed, the heads in the order walked).
    ``skip`` (i, j): y's walk leaves that causal tile out; ``read_above``:
    y's walk also reads the s-block just above each diagonal, 2 i + 2.  A
    test holds both to fail."""
    bc, l, h, p = x.shape
    g, n = b.shape[2:]
    rep, lr = h // g, -(-l // 16) * 16
    kbs = -(-l // 8)
    y = np.full(x.shape, np.nan, np.float32)
    st = np.full((bc, h, p, n), np.nan, np.float32)
    gq, t = np.arange(32) // 4, np.arange(32) % 4
    perm = np.concatenate([2 * np.arange(4), 2 * np.arange(4) + 1])
    tiles, walk = set(), []

    def pad(a):
        out = np.zeros((lr,) + a.shape[1:], np.float64)
        out[:a.shape[0]] = a
        return out

    for q in range(bc):
        for gg in range(g):
            cm, bm = pad(c[q, :, gg]), pad(b[q, :, gg])
            tri = {}
            for i in range(lr // 16):
                for j in range(2 * i + 2):
                    cb = cm[16 * i:16 * i + 16] @ bm[8 * j:8 * j + 8].T
                    # lane 4 g + t holds (g, 2t), (g + 8, 2t), (g, 2t + 1),
                    # (g + 8, 2t + 1)
                    tri[i, j] = np.stack([cb[gq, 2 * t], cb[gq + 8, 2 * t],
                                          cb[gq, 2 * t + 1],
                                          cb[gq + 8, 2 * t + 1]], axis=1)
                    tiles.add((i, j))
            for h0 in range(gg * rep, (gg + 1) * rep, heads):
                for hh in range(h0, min(h0 + heads, (gg + 1) * rep)):
                    walk.append((q, hh))
                    xs, cs = pad(x[q, :, hh]), pad(da_cs[q, :, hh])
                    yy = np.zeros((lr, p))
                    for i in range(lr // 16):
                        rows = 16 * i + np.arange(16)
                        walked = list(range(min(2 * i + 2, kbs)))
                        for kb in walked + [2 * i + 2] * read_above:
                            if (i, kb) == skip:
                                continue
                            v = tri[i, kb]          # (lane, 4)
                            a = np.zeros((16, 8))   # depth in fragment order
                            a[gq, t], a[gq + 8, t] = v[:, 0], v[:, 1]
                            a[gq, t + 4], a[gq + 8, t + 4] = v[:, 2], v[:, 3]
                            s_ = 8 * kb + perm
                            diff = cs[rows][:, None] - cs[s_][None, :]
                            mask = s_[None, :] <= rows[:, None]
                            a *= np.exp(np.where(mask, diff, -np.inf))
                            yy[rows] += a @ xs[s_]
                    y[q, :, hh] = yy[:l]
                    w = np.where(np.arange(lr) < l,
                                 np.exp(cs[l - 1] - cs), 0.0)
                    sacc = np.zeros((p, n))
                    for kb in range(kbs):
                        s_ = 8 * kb + perm
                        sacc += (xs[s_] * w[s_, None]).T @ bm[s_]
                    st[q, hh] = sacc
    return y, st, tiles, walk


@pytest.mark.parametrize("da_scale", [0.1, 2.0], ids=["decay0.1", "decay2"])
@pytest.mark.parametrize("shape", SSD_SHAPES,
                         ids=[str(s) for s in SSD_SHAPES])
def test_kernel_tile_walk_matches_the_oracle(shape, da_scale):
    # the tile walk of csrc/ssd.cu (tests/test_torch_cuda.py runs the
    # kernel itself at these shapes): every causal tile of C B^T once per
    # group, none above the diagonal, heads walked in order, the decay
    # masked before exp (finite at chunk |dA| sums far above 88)
    bc, l, h, p, g, n = shape
    x, da_cs, b, c = _intra_inputs(shape, seed=sum(shape), scale=da_scale)
    y, st, tiles, walk = _emulate_ssd(x, da_cs, b, c)
    lt = -(-l // 16)
    assert tiles == {(i, j) for i in range(lt) for j in range(2 * i + 2)}
    assert walk == [(q, hh) for q in range(bc) for hh in range(h)]
    assert np.isfinite(y).all() and np.isfinite(st).all()
    y_ref, st_ref = ssd_intra_chunk_ref(*_t(x, da_cs, b, c))
    _close(torch.from_numpy(y), y_ref.numpy())
    _close(torch.from_numpy(st), st_ref.numpy())
    if bc * h > 32:
        return
    # the walk holds the kernel to the oracle: leaving out a causal tile
    # (the first, or the last l-tile's last) changes y, and a read above
    # the diagonal finds no tile there
    for skip in ((0, 0), (lt - 1, min(2 * lt, -(-l // 8)) - 1)):
        y_skip, *_ = _emulate_ssd(x, da_cs, b, c, skip=skip)
        err = np.abs(y_skip - y_ref.numpy()).max()
        assert err > 1e-3 * np.abs(y_ref.numpy()).max()
    with pytest.raises(KeyError):
        _emulate_ssd(x, da_cs, b, c, read_above=True)


def _emulate_ssd_bwd(x, da_cs, b, c, dy, dst, heads=24, skip=None,
                     read_above=False):
    """csrc/ssd_bwd.cu's walk in numpy (float64).  Launch 1, block by block
    (chunk, group, tile of ``heads`` heads): (B C^T)'s causal 16 x 8 tiles
    (s-tile i, l-block j >= 2 i, within the chunk) formed once; then per
    head, in order, Z += (w X) dst; dX = (w B) dst^T, tw from it and X,
    then + att^T dy over the causal l-blocks only; datt^T on the causal
    tiles only, dCB_h = datt^T * decay with the decay masked before exp,
    M's row and column sums by tile, dCB_h summed over the tile's heads;
    dcs from the tiles' sums.  Each block leaves a partial of dCB (by
    tile) and of Z.  Launch 2, per (chunk, group): the partials summed in
    head-tile order, dC = dCB B and dB = Z + dCB^T C over the causal
    tiles.  Returns (dx, dda, db, dc, the blocks in launch order, the
    tiles formed).  ``skip`` (i, j): the walk leaves that causal tile out;
    ``read_above``: att^T dy also reads the l-block 2 i - 1, wholly above
    the diagonal (a KeyError: no such tile).  A test holds both to fail.
    """
    bc, l, h, p = x.shape
    g, n = b.shape[2:]
    rep, lr, lb = h // g, -(-l // 16) * 16, -(-l // 8)
    tiles = [(i, j) for i in range(lr // 16) for j in range(2 * i, lb)]
    dx = np.zeros(x.shape)
    dda = np.zeros(da_cs.shape)
    db = np.zeros(b.shape)
    dc = np.zeros(c.shape)
    blocks, formed = [], set()
    rows = np.arange(lr)

    def pad(a):
        out = np.zeros((lr,) + a.shape[1:])
        out[:a.shape[0]] = a
        return out

    for q in range(bc):
        for gg in range(g):
            bm, cm = pad(b[q, :, gg]), pad(c[q, :, gg])
            cbt = {}
            for i, j in tiles:
                cbt[i, j] = bm[16 * i:16 * i + 16] @ cm[8 * j:8 * j + 8].T
                formed.add((i, j))
            parts = []
            for t0 in range(gg * rep, (gg + 1) * rep, heads):
                blocks.append((q, gg, t0))
                dcb = {k: np.zeros((16, 8)) for k in tiles}
                z = np.zeros((lr, n))
                for hh in range(t0, min(t0 + heads, (gg + 1) * rep)):
                    xs, ys = pad(x[q, :, hh]), pad(dy[q, :, hh])
                    cs = pad(da_cs[q, :, hh])
                    w = np.where(rows < l, np.exp(cs[l - 1] - cs), 0.0)
                    z += (w[:, None] * xs) @ dst[q, hh]
                    dxs = (w[:, None] * bm) @ dst[q, hh].T
                    tw = (xs * dxs).sum(1)
                    rowp, colp = {}, {}
                    for i in range(lr // 16):
                        s_ = 16 * i + np.arange(16)
                        walked = [j for j in range(2 * i, lb)
                                  if (i, j) != skip]
                        for j in walked + [2 * i - 1] * read_above:
                            l_ = 8 * j + np.arange(8)
                            mask = (s_[:, None] <= l_[None, :]) & (
                                l_[None, :] < l)
                            # the mask first: exp only on the taps
                            dec = np.exp(np.where(mask, cs[l_][None, :]
                                                  - cs[s_][:, None], -np.inf))
                            dxs[s_] += (cbt[i, j] * dec) @ ys[l_]
                            datt = xs[s_] @ ys[l_].T
                            m = datt * dec * cbt[i, j]
                            dcb[i, j] += datt * dec
                            rowp[i, j], colp[i, j] = m.sum(1), m.sum(0)
                    dx[q, :, hh] = dxs[:l]
                    for xx in range(l):
                        jx, ix = xx // 8, xx // 16
                        col = sum(colp[i, jx][xx % 8]
                                  for i in range(jx // 2 + 1)
                                  if (i, jx) in colp)
                        row = sum(rowp[ix, j][xx % 16]
                                  for j in range(2 * ix, lb)
                                  if (ix, j) in rowp)
                        dda[q, xx, hh] = col - row - tw[xx]
                    dda[q, l - 1, hh] += tw[:l].sum()
                parts.append((dcb, z))
            # launch 2: the partials in head-tile order
            dcbt = np.zeros((lr, lr))
            zs = np.zeros((lr, n))
            for part, zp in parts:
                for (i, j), v in part.items():
                    dcbt[16 * i:16 * i + 16, 8 * j:8 * j + 8] += v
                zs += zp
            for i in range(lr // 16):
                r_ = 16 * i + np.arange(16)
                ks = 8 * np.arange(min(2 * i + 2, lb))
                s_ = (ks[:, None] + np.arange(8)).ravel()
                dc[q, r_[r_ < l], gg] = (dcbt[s_][:, r_].T @ bm[s_])[r_ < l]
                l_ = np.arange(16 * i, 8 * lb)
                db[q, r_[r_ < l], gg] = (zs[r_] + dcbt[r_][:, l_] @ cm[l_])[
                    r_ < l]
    return dx, dda, db, dc, blocks, formed


def _bwd_inputs(shape, da_scale, seed):
    bc, l, h, p, g, n = shape
    x, da_cs, b, c = _intra_inputs(shape, seed, scale=da_scale)
    rng = np.random.default_rng(seed + 1)
    dy = rng.normal(size=(bc, l, h, p)).astype(np.float32)
    dst = rng.normal(size=(bc, h, p, n)).astype(np.float32)
    return (x, da_cs, b, c), (dy, dst)


@pytest.mark.parametrize("big", [False, True], ids=["", "large-decay"])
@pytest.mark.parametrize("shape", SSD_BWD_SHAPES,
                         ids=[str(s) for s in SSD_BWD_SHAPES])
def test_backward_kernel_tile_walk_matches_autograd(shape, big):
    # the walk of csrc/ssd_bwd.cu (tests/test_torch_cuda.py runs the kernel
    # itself at these shapes): blocks per (chunk, group, head tile), the
    # causal tiles only, the decay masked before exp (finite where chunk
    # |dA| sums pass 88), the partials summed in head-tile order
    bc, l, h, p, g, n = shape
    ins, cots = _bwd_inputs(shape, 256.0 / l if big else 0.1,
                            seed=sum(shape))
    if big:
        assert float(-ins[1][:, -1].max()) > 88.0
    dx, dda, db, dc, blocks, formed = _emulate_ssd_bwd(*ins, *cots)
    lb = -(-l // 8)
    assert formed == {(i, j) for i in range(-(-l // 16))
                      for j in range(2 * i, lb)}
    rep = h // g
    assert blocks == [(q, gg, t0) for q in range(bc) for gg in range(g)
                      for t0 in range(gg * rep, (gg + 1) * rep, 24)]
    got = (dx, dda, db, dc)
    assert all(np.isfinite(a).all() for a in got)
    # float64 autograd of the plain version, and the port's own plain
    # backward (float32, ssd_intra_chunk_bwd_ref) at the gradient bar
    ts = [torch.from_numpy(a).double().requires_grad_(True) for a in ins]
    want = torch.autograd.grad(ssd_intra_chunk_ref(*ts), ts,
                               [torch.from_numpy(a).double() for a in cots])
    plain = ssd_ops.ssd_intra_chunk_bwd(*_t(*ins), *_t(*cots))
    for a, w, f in zip(got, want, plain):
        np.testing.assert_allclose(a, w.numpy(), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(a, f.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    if bc * h > 18 or big:
        return
    # the walk holds the kernel to the plain version: leaving out a causal
    # tile (the first, or the last s-tile's last) changes the gradients,
    # and a read above the diagonal finds no tile there
    lt = -(-l // 16)
    for skip in ((0, 0), (lt - 1, lb - 1)):
        off = _emulate_ssd_bwd(*ins, *cots, skip=skip)[:4]
        assert max(np.abs(a - w.numpy()).max() - GRAD_RTOL * np.abs(
            w.numpy()).max() for a, w in zip(off, want)) > GRAD_ATOL
    with pytest.raises(KeyError):
        _emulate_ssd_bwd(*ins, *cots, read_above=True)
