"""The port's kernel wrappers, plain versions and dispatch against the JAX
package's Pallas kernels (run in interpret mode) and their oracles; the
backward of each kernel call against JAX's VJP.

On the CPU every wrapper computes its plain version; the CUDA kernels
themselves are held to those plain versions in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import few_torch_threads  # noqa: F401

from repro.core.sphere import disco as jdisco
from repro.core.sphere import grids as jgrids
from repro.core.sphere import sht as jsht
from repro.kernels import dispatch as jdispatch
from repro.kernels.config import KernelConfig as JKernelConfig
from repro.kernels.disco.disco import disco_band_contract as j_band_pallas
from repro.kernels.disco.ref import disco_band_contract_ref as j_band_ref
from repro.kernels.legendre.legendre import legendre_contract as j_leg_pallas
from repro.kernels.legendre.ref import legendre_contract_ref as j_leg_ref
from repro_torch.core.sphere import disco as tdisco
from repro_torch.core.sphere import grids as tgrids
from repro_torch.core.sphere import sht as tsht
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels.config import BLOCK_DEFAULTS
from repro_torch.kernels.disco import ops as disco_ops
from repro_torch.kernels.disco.ref import (disco_band_contract_ref,
                                           disco_band_transpose_ref,
                                           disco_gather_band_contract_ref)
from repro_torch.kernels.legendre import ops as legendre_ops
from repro_torch.kernels.legendre.ref import legendre_contract_ref

PALLAS = JKernelConfig(sht="pallas", disco="pallas", interpret=True)
PAIRS = [((64, 128, "equiangular"), (32, 64, "gauss")),   # encoder, stride 2
         ((16, 32, "gauss"), (16, 32, "gauss")),          # latent block
         ((33, 64, "equiangular"), (33, 64, "equiangular"))]  # decoder
PAIR_IDS = ["enc", "latent", "dec"]


def _rng(seed):
    return np.random.default_rng(seed)


def _plans(pair):
    gi, go = pair
    return (jdisco.make_disco_plan(jgrids.make_grid(*gi),
                                   jgrids.make_grid(*go)),
            tdisco.make_disco_plan(tgrids.make_grid(*gi),
                                   tgrids.make_grid(*go)))


class TestLegendre:
    @pytest.mark.parametrize("b,k,n,m", [(3, 16, 16, 9), (5, 33, 20, 17)])
    def test_plain_matches_oracle_and_pallas(self, b, k, n, m):
        r = _rng(b)
        x = r.standard_normal((b, k, m)).astype(np.float32)
        t = r.standard_normal((k, n, m)).astype(np.float32)
        got = legendre_ops.legendre_contract(
            torch.from_numpy(x), torch.from_numpy(t),
            torch.from_numpy(tsht.order_extents(t))).numpy()
        np.testing.assert_allclose(
            got, np.asarray(j_leg_ref(jnp.asarray(x), jnp.asarray(t))),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            got, np.asarray(j_leg_pallas(jnp.asarray(x), jnp.asarray(t),
                                         interpret=True)),
            rtol=1e-5, atol=1e-5)
        assert legendre_contract_ref(torch.from_numpy(x),
                                     torch.from_numpy(t)).shape == (b, n, m)

    def test_complex_strided_plain_matches_oracle(self):
        # the SHT's call: complex x, and (inverse) a transposed table view
        r = _rng(9)
        xr, xi = r.standard_normal((2, 4, 16, 9)).astype(np.float32)
        t = r.standard_normal((20, 16, 9)).astype(np.float32)
        tt = torch.from_numpy(t).permute(1, 0, 2)          # (16, 20, 9)
        got = legendre_ops.legendre_contract(
            torch.complex(torch.from_numpy(xr), torch.from_numpy(xi)), tt,
            torch.from_numpy(tsht.order_extents(tt.numpy())))
        assert got.dtype == torch.complex64 and got.shape == (4, 20, 9)
        jt = jnp.asarray(t).transpose(1, 0, 2)
        for part, xp in ((got.real, xr), (got.imag, xi)):
            np.testing.assert_allclose(
                part.numpy(), np.asarray(j_leg_ref(jnp.asarray(xp), jt)),
                rtol=1e-5, atol=1e-5)

    def test_sht_dispatch_matches_pallas_dispatch(self):
        g = (32, 64, "gauss")
        j = jsht.SHT.create(jgrids.make_grid(*g))
        jb = j.buffers()
        tb = tsht.SHT.create(tgrids.make_grid(*g)).buffers()
        x = _rng(0).standard_normal((3, 32, 64)).astype(np.float32)
        cj = jdispatch.sht_forward(jnp.asarray(x), jb["wpct"], PALLAS)
        ct = tdispatch.sht_forward(torch.from_numpy(x), tb["wpct"],
                                   tb["wpct_ext"])
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
        c = np.asarray(cj)
        np.testing.assert_allclose(
            tdispatch.sht_inverse(torch.from_numpy(c), tb["pct"], 64,
                                  tb["pct_ext"]).numpy(),
            np.asarray(jdispatch.sht_inverse(jnp.asarray(c), jb["pct"], 64,
                                             PALLAS)), atol=1e-4)

    def test_backward_runs_plain_vjp(self):
        # on the CPU the backward is the wrapper's plain version on the
        # transposed table; the table is a constant and gets no gradient
        r = _rng(1)
        x = torch.from_numpy(r.standard_normal((2, 6, 4)).astype(np.float32))
        t = torch.from_numpy(r.standard_normal((6, 5, 4)).astype(np.float32))
        x.requires_grad_(True)
        t.requires_grad_(True)
        ext = torch.from_numpy(tsht.order_extents(t.detach().numpy()))
        tdispatch._Legendre.apply(x, t, ext).square().sum().backward()
        xr = x.detach().clone().requires_grad_()
        legendre_contract_ref(xr, t.detach()).square().sum().backward()
        torch.testing.assert_close(x.grad, xr.grad)
        assert t.grad is None

    def test_complex_backward_runs_plain_vjp(self):
        r = _rng(2)
        xr, xi = r.standard_normal((2, 2, 6, 4)).astype(np.float32)
        x = torch.complex(torch.from_numpy(xr), torch.from_numpy(xi))
        t = torch.from_numpy(r.standard_normal((6, 5, 4)).astype(np.float32))
        ext = torch.from_numpy(tsht.order_extents(t.numpy()))
        grads = []
        for fn in (lambda a, b: tdispatch._Legendre.apply(a, b, ext),
                   legendre_contract_ref):
            xl = x.clone().requires_grad_()
            fn(xl, t).abs().square().sum().backward()
            grads.append(xl.grad)
        assert grads[0].dtype == torch.complex64
        torch.testing.assert_close(grads[0], grads[1])

    def test_sht_gradient_matches_jax_vjp(self):
        # both SHT directions' x-gradients through the kernel path's
        # backward (the table transposed) against jax.vjp of the
        # reference SHT; a complex cotangent in JAX is the conjugate of
        # torch's gradient (both give the same real-loss gradients)
        g = (16, 32, "gauss")
        jb = jsht.SHT.create(jgrids.make_grid(*g)).buffers()
        tb = tsht.SHT.create(tgrids.make_grid(*g)).buffers()
        r = _rng(3)
        x = r.standard_normal((3, 16, 32)).astype(np.float32)
        ct = r.standard_normal((3, 16, 16)).astype(np.float32)
        _, vjp = jax.vjp(lambda a: jsht.sht_forward(a, jb["wpct"]),
                         jnp.asarray(x))
        (want,) = vjp(jnp.asarray(ct - 0.5j * ct, jnp.complex64))
        xt = torch.from_numpy(x).requires_grad_()
        got = torch.autograd.grad(
            tdispatch.sht_forward(xt, tb["wpct"], tb["wpct_ext"]), xt,
            torch.from_numpy(ct + 0.5j * ct).to(torch.complex64))[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
        c = (r.standard_normal((3, 16, 16))
             + 1j * r.standard_normal((3, 16, 16))).astype(np.complex64)
        _, vjp = jax.vjp(lambda a: jsht.sht_inverse(a, jb["pct"], 32),
                         jnp.asarray(c))
        (want,) = vjp(jnp.asarray(x))
        cc = torch.from_numpy(c).requires_grad_()
        got = torch.autograd.grad(
            tdispatch.sht_inverse(cc, tb["pct"], 32, tb["pct_ext"]), cc,
            torch.from_numpy(x))[0]
        np.testing.assert_allclose(got.numpy(), np.conj(np.asarray(want)),
                                   rtol=1e-4, atol=1e-4)


class TestDiscoBand:
    @pytest.mark.parametrize("stride", [1, 2])
    def test_band_ref_matches_oracle_and_pallas(self, stride):
        r = _rng(stride)
        xg = r.standard_normal((3, 5, 4, 32)).astype(np.float32)
        psi = r.standard_normal((7, 5, 4, 7)).astype(np.float32)
        got = disco_band_contract_ref(torch.from_numpy(xg),
                                      torch.from_numpy(psi), stride).numpy()
        np.testing.assert_allclose(
            got, np.asarray(j_band_ref(jnp.asarray(xg), jnp.asarray(psi),
                                       stride=stride)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            got, np.asarray(j_band_pallas(jnp.asarray(xg), jnp.asarray(psi),
                                          stride=stride, interpret=True)),
            rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
    def test_wrapper_plain_is_roll_gather_band(self, pair):
        # the kernel's function: dispatch.py's roll + _gather_band, then
        # the band oracle -- composed on the JAX side for reference
        jp, tp = _plans(pair)
        band, _, _ = jp._banded_split()
        gi = pair[0]
        x = _rng(4).standard_normal((2, gi[0], gi[1])).astype(np.float32)
        d = band.shape[-1]
        xr = jnp.roll(jnp.asarray(x), d // 2, axis=-1)
        xg = jdisco._gather_band(xr, jp.lat_idx, jp.affine, band.shape[1])
        ref = j_band_ref(xg, jnp.asarray(band), stride=jp.stride)
        tb = tp.banded_buffers()
        got = disco_ops.disco_band_contract(
            torch.from_numpy(x), tb["psi_band"], tb["lat_idx"],
            disco_ops.LiveTaps.of(tb), tp.stride)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
    def test_banded_dispatch_matches_jax(self, pair):
        jp, tp = _plans(pair)
        gi = pair[0]
        x = _rng(5).standard_normal((2, gi[0], gi[1])).astype(np.float32)
        ref = jdispatch.disco_conv_banded_buffers(
            jnp.asarray(x), jp.banded_buffers(), jp.stride, jp.affine, PALLAS)
        got = tdispatch.disco_conv_banded_buffers(
            torch.from_numpy(x), tp.banded_buffers(), tp.stride)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
        # and the port's FFT reference on the full psi
        fft = tdisco.disco_conv(torch.from_numpy(x), torch.from_numpy(tp.psi),
                                torch.from_numpy(tp.lat_idx), tp.stride)
        np.testing.assert_allclose(got.numpy(), fft.numpy(), atol=1e-5)

    def test_backward_runs_plain_vjp(self):
        # the backward is the transpose's plain version; psi_band and the
        # index buffers are constants and get no gradient
        _, tp = _plans(PAIRS[1])
        tb = tp.banded_buffers()
        x = torch.from_numpy(_rng(6).standard_normal(
            (2, 16, 32)).astype(np.float32)).requires_grad_()
        psi = tb["psi_band"].clone().requires_grad_()
        tdispatch._BandContract.apply(
            x, psi, tb["lat_idx"], disco_ops.LiveTaps.of(tb),
            disco_ops.RowTaps.of(tb), 1).square().sum().backward()
        xr = x.detach().clone().requires_grad_()
        disco_gather_band_contract_ref(xr, psi.detach(), tb["lat_idx"],
                                       1).square().sum().backward()
        torch.testing.assert_close(x.grad, xr.grad)
        assert psi.grad is None

    @pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
    def test_transpose_plain_matches_jax_vjp(self, pair):
        # stride 2 (enc) and stride 1 (latent, dec): the plain transpose
        # against jax.vjp of the JAX package's roll + gather + band
        # oracle, and the whole banded path (with its FFT wrap rows)
        # against jax.vjp of the JAX dispatch
        jp, tp = _plans(pair)
        band, _, _ = jp._banded_split()
        gi = pair[0]
        r = _rng(8)
        x = r.standard_normal((2, gi[0], gi[1])).astype(np.float32)
        d = band.shape[-1]

        def j_band(a):
            xg = jdisco._gather_band(jnp.roll(a, d // 2, axis=-1),
                                     jp.lat_idx, jp.affine, band.shape[1])
            return j_band_ref(xg, jnp.asarray(band), stride=jp.stride)

        out, vjp = jax.vjp(j_band, jnp.asarray(x))
        g = r.standard_normal(out.shape).astype(np.float32)
        (want,) = vjp(jnp.asarray(g))
        tb = tp.banded_buffers()
        got = disco_ops.disco_band_transpose(
            torch.from_numpy(g), tb["psi_band"], tb["lat_idx"],
            disco_ops.LiveTaps.of(tb), disco_ops.RowTaps.of(tb), gi[0],
            tp.stride)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            disco_band_transpose_ref(torch.from_numpy(g), tb["psi_band"],
                                     tb["lat_idx"], gi[0],
                                     tp.stride).numpy(), got.numpy())

        _, vjp = jax.vjp(lambda a: jdispatch.disco_conv_banded_buffers(
            a, jp.banded_buffers(), jp.stride, jp.affine, PALLAS),
            jnp.asarray(x))
        (want,) = vjp(jnp.asarray(g))
        xt = torch.from_numpy(x).requires_grad_()
        out = tdispatch.disco_conv_banded_buffers(xt, tb, tp.stride)
        (got,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("stride", [3])
    def test_transpose_plain_matches_jax_vjp_any_stride(self, stride):
        # a stride no fcn3 geometry has: the plain transpose against
        # jax.vjp of the JAX package's roll + gather + band oracle, on a
        # band with holes and any lat_idx (the CUDA kernel takes this
        # stride through its generic path)
        band = _band_with_holes(30 + stride)
        k, h_out, s, d = band.shape
        r = _rng(31 + stride)
        h_in, w_out = 12, 40
        lat_idx = r.integers(0, h_in, (h_out, s)).astype(np.int32)
        x = r.standard_normal((2, h_in, w_out * stride)).astype(np.float32)

        def j_band(a):
            xg = jdisco._gather_band(jnp.roll(a, d // 2, axis=-1), lat_idx,
                                     None, h_out)
            return j_band_ref(xg, jnp.asarray(band), stride=stride)

        out, vjp = jax.vjp(j_band, jnp.asarray(x))
        assert out.shape == (2, k, h_out, w_out)
        g = r.standard_normal(out.shape).astype(np.float32)
        (want,) = vjp(jnp.asarray(g))
        got = disco_band_transpose_ref(torch.from_numpy(g),
                                       torch.from_numpy(band),
                                       torch.from_numpy(lat_idx), h_in,
                                       stride)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            disco_gather_band_contract_ref(
                torch.from_numpy(x), torch.from_numpy(band),
                torch.from_numpy(lat_idx), stride).numpy(),
            np.asarray(out), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
    def test_row_lists_invert_lat_idx(self, pair):
        # the transpose kernel's lists (band_row_taps): every live slice of
        # band_live_taps once, under its input row lat_idx[h, s], in
        # order; every input row in the order, heaviest first
        _, tp = _plans(pair)
        h_in = pair[0][0]
        taps = tdisco.band_live_taps(tp.banded_split()[0])
        rows = tdisco.band_row_taps(tp.lat_idx, taps, h_in)
        ptr, ent, ent_tap = rows["in_ptr"], rows["in_ent"], taps["tap_ent"]
        assert ptr[0] == 0 and ptr[-1] == len(ent) == len(ent_tap)
        assert sorted(ent[:, 1]) == list(range(len(ent_tap)))
        for h, e in ent:
            assert taps["tap_ptr"][h] <= e < taps["tap_ptr"][h + 1]
        work = np.zeros(h_in)
        for r in range(h_in):
            mine = ent[ptr[r]:ptr[r + 1]]
            assert list(mine[:, 1]) == sorted(mine[:, 1])
            assert all(tp.lat_idx[h, ent_tap[e, 0]] == r for h, e in mine)
            work[r] = sum(-(-ent_tap[e, 2] // 8) * 8 for e in mine[:, 1])
        assert sorted(rows["in_order"]) == list(range(h_in))
        assert np.all(np.diff(work[rows["in_order"]]) <= 0)
        assert all(a.dtype == np.int32 for a in rows.values())

    @pytest.mark.parametrize("which", ["holes-1", "holes-2", "holes-3",
                                       "holes-4"] + PAIR_IDS)
    def test_transpose_over_row_taps_matches_plain(self, which):
        # the function the transpose kernel computes from the lists, in
        # numpy: its tiles, pieces, u windows (wrapped), zero margins,
        # Toeplitz fragments by (delta, parity) and output mapping,
        # against the plain version
        if which.startswith("holes"):
            stride = int(which[-1])
            band = _band_with_holes(13 + stride)
            r = _rng(20 + stride)
            lat_idx = r.integers(0, 12, band.shape[1:3]).astype(np.int32)
            # above stride 2 (the generic path) wide enough for every
            # warp and two tiles of each residue class
            h_in, w_out = 12, 31 if stride <= 2 else 300
        else:
            _, tp = _plans(PAIRS[PAIR_IDS.index(which)])
            band, lat_idx, stride = tp.banded_split()[0], tp.lat_idx, tp.stride
            h_in, w_out = tp.grid_in.nlat, tp.grid_out.nlon
            r = _rng(24)
        k, h_out, _, d = band.shape
        g = r.standard_normal((3, k, h_out, w_out)).astype(np.float32)
        got = _emulate_transpose(g, band, lat_idx, h_in, stride)
        ref = disco_band_transpose_ref(torch.from_numpy(g),
                                       torch.from_numpy(band),
                                       torch.from_numpy(lat_idx), h_in,
                                       stride)
        np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("ch", [16, 32, 48])
    @pytest.mark.parametrize("stride", [1, 2, 3])
    def test_transpose_tiles_match_plain(self, ch, stride):
        # the kernel's arithmetic at the other pieces the autotuner's
        # "disco_bwd" lattice builds (-DTUNE_CH), on a band with holes
        band = _band_with_holes(13 + stride)
        r = _rng(40 + stride)
        lat_idx = r.integers(0, 12, band.shape[1:3]).astype(np.int32)
        h_in, w_out = 12, 31 if stride <= 2 else 300
        k, h_out = band.shape[:2]
        g = r.standard_normal((3, k, h_out, w_out)).astype(np.float32)
        got = _emulate_transpose(g, band, lat_idx, h_in, stride, ch=ch)
        ref = disco_band_transpose_ref(torch.from_numpy(g),
                                       torch.from_numpy(band),
                                       torch.from_numpy(lat_idx), h_in,
                                       stride)
        np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=1e-5)


#: csrc/disco_band_bwd.cu's fixed constants: input longitudes a block and
#: the generic path's Toeplitz offsets (less one)
TRANSPOSE_TV, TRANSPOSE_DM_ANY = 256, 3


def _emulate_transpose(g, band, lat_idx, h_in, stride,
                       ch=BLOCK_DEFAULTS["disco_bwd"]["CH"]):
    """csrc/disco_band_bwd.cu's arithmetic in numpy, for every block of
    its grid: input row r from the lists, a tile of TV longitudes split
    into warps of VW (above stride 2: TV longitudes of one residue class
    v = cls + S n, the generic path), slices cut into pieces of at most
    CH taps; per (piece, k) the staged taps with zero margins and the g
    window from u0 = floor((v0 - c - taps) / S), wrapped; n-tile j of
    parity par and u-block i = j + delta meet in the 8 x 8 operand
    B_delta[q, n] = P[base + par - 8 S delta + S (n - q)].  ``ch``: the
    taps of a piece (the tile's CH)."""
    tv, vw, s_ = TRANSPOSE_TV, 32, stride
    b, k, h_out, w_out = g.shape
    d = band.shape[-1]
    w_in = w_out * stride
    taps = tdisco.band_live_taps(band)
    rows = tdisco.band_row_taps(lat_idx, taps, h_in)
    generic = s_ > 2
    margin, nw = 16 * s_, tv // vw
    # per block: the first longitudes, the step between outputs, the
    # parities, the n-tiles of one parity a warp and the u offset of a warp
    if generic:
        starts = [c + s_ * t * tv for t in range(-(-w_out // tv))
                  for c in range(s_)]
        vstep, npar, nt, wu = s_, 1, vw // 8, vw
    else:
        starts = range(0, w_in, tv)
        vstep, npar, nt, wu = 1, s_, vw // (8 * s_), vw // s_
    out = np.full((b, h_in, w_in), np.nan)
    q8 = np.arange(8)
    for r in rows["in_order"]:
        for v0 in starts:
            acc = np.zeros((b, nw, npar, nt, 8))
            for h, e in rows["in_ent"][rows["in_ptr"][r]:rows["in_ptr"][r + 1]]:
                _, d_lo, span, off = taps["tap_ent"][e]
                for pc in range(-(-(-(-span // 8) * 8) // ch)):
                    n_taps = min(ch, -(-span // 8) * 8 - pc * ch)
                    nd = (n_taps + 9 * s_ - 2) // (8 * s_)
                    assert not generic or nd <= TRANSPOSE_DM_ANY
                    c = d_lo + pc * ch - d // 2
                    u0 = (v0 - c - n_taps) // s_
                    base = v0 - c - s_ * u0
                    assert n_taps <= base < n_taps + s_
                    ncols = (tv if generic else tv // s_) + 8 * nd
                    for kk in range(k):
                        ps = np.zeros(ch + 2 * margin)
                        ps[margin:margin + n_taps] = taps["tap_psi"][
                            off + pc * ch:off + pc * ch + n_taps, kk]
                        win = g[:, kk, h, (u0 + np.arange(ncols)) % w_out]
                        for delta in range(nd + 1):
                            # u-blocks i = j + delta of every warp
                            cols = (np.arange(nw)[:, None, None] * wu
                                    + 8 * (np.arange(nt)[None, :, None]
                                           + delta) + q8)    # (nw, nt, 8)
                            a = win[:, cols]                 # (b, nw, nt, 8)
                            for par in range(npar):
                                tau = (base + par - 8 * s_ * delta
                                       + s_ * (q8[None, :] - q8[:, None]))
                                at = margin + tau            # [q, n]
                                assert 0 <= at.min() <= at.max() < ps.size
                                bmat = ps[at]
                                acc[:, :, par] += a @ bmat
            v = (v0 + vstep * np.arange(nw)[:, None, None, None] * vw
                 + np.arange(npar)[None, :, None, None]
                 + s_ * (8 * np.arange(nt)[None, None, :, None]
                         + q8))                              # (nw, P, nt, 8)
            keep = v < w_in
            assert np.isnan(out[:, r, v[keep]]).all()        # written once
            out[:, r, v[keep]] = acc[:, keep]
    return out


def _band_with_holes(seed):
    """A band-shaped psi (K, H, S, D) with scattered interior zeros, dead
    slices, a dead row and a slice whose only nonzeros are its end taps."""
    r = _rng(seed)
    band = r.standard_normal((7, 9, 5, 23)).astype(np.float32)
    band[r.random(band.shape) < 0.3] = 0
    band[:, 2, 1] = 0
    band[:, 4] = 0
    band[..., :3] = 0
    band[:, 6, 3] = 0
    band[:, 6, 3, [4, 20]] = 1.5
    return band


def _taps_dense(taps, shape):
    """The dense band the live taps describe."""
    k, h_out, s, d = shape
    out = np.zeros(shape, np.float32)
    for h in range(h_out):
        for ss, lo, span, off in taps["tap_ent"][
                taps["tap_ptr"][h]:taps["tap_ptr"][h + 1]]:
            out[:, h, ss, lo:lo + span] = taps["tap_psi"][off:off + span,
                                                          :k].T
    return out


class TestLiveTaps:
    @pytest.mark.parametrize("which", PAIR_IDS + ["holes"])
    def test_cover_every_nonzero_and_drop_dead_slices(self, which):
        if which == "holes":
            band = _band_with_holes(10)
        else:
            band = _plans(PAIRS[PAIR_IDS.index(which)])[1].banded_split()[0]
        taps = tdisco.band_live_taps(band)
        k, h_out, s, d = band.shape
        assert np.array_equal(_taps_dense(taps, band.shape), band)
        live = np.flatnonzero((band != 0).any(axis=(0, 3)).reshape(-1))
        ent = taps["tap_ent"]
        hs = [h * s + e[0] for h in range(h_out)
              for e in ent[taps["tap_ptr"][h]:taps["tap_ptr"][h + 1]]]
        assert hs == list(live)                   # dead slices dropped
        for h, (ss, lo, span, off) in zip(np.array(hs) // s, ent):
            nz = np.flatnonzero((band[:, h, ss] != 0).any(axis=0))
            assert (lo, lo + span) == (nz[0], nz[-1] + 1)   # tight span
            assert off % tdisco.TAP_STEP == 0
            assert not taps["tap_psi"][off + span:off + -(-span // 8) * 8].any()
        assert taps["tap_psi"].shape[1] == tdisco.TAP_BASIS
        assert not taps["tap_psi"][:, k:].any()
        work = np.diff(taps["tap_ptr"])
        assert sorted(taps["row_order"]) == list(range(h_out))
        padded = np.zeros(h_out)
        for h, e in zip(np.array(hs) // s, ent):
            padded[h] += -(-e[2] // 8) * 8
        assert np.all(np.diff(padded[taps["row_order"]]) <= 0)
        assert work.sum() == len(ent)

    @pytest.mark.parametrize("stride", [1, 2])
    def test_contraction_over_live_taps_matches_plain(self, stride):
        # the function the forward kernel computes from the live taps (its
        # window and wrap arithmetic, in numpy) against the plain version
        band = _band_with_holes(11 + stride)
        r = _rng(stride)
        lat_idx = r.integers(0, 12, band.shape[1:3]).astype(np.int32)
        x = r.standard_normal((3, 12, 30 * stride)).astype(np.float32)
        taps = tdisco.band_live_taps(band)
        k, h_out, s, d = band.shape
        w_in = x.shape[-1]
        w = np.arange(w_in // stride)
        got = np.zeros((3, k, h_out, w.size))
        for h in range(h_out):
            for ss, lo, span, off in taps["tap_ent"][
                    taps["tap_ptr"][h]:taps["tap_ptr"][h + 1]]:
                for t in range(-(-span // 8) * 8):
                    col = (w * stride + lo + t - d // 2) % w_in
                    xv = x[:, lat_idx[h, ss]][:, col]          # (B, W_out)
                    got[:, :, h] += (taps["tap_psi"][off + t, :k, None, None]
                                     * xv[None]).transpose(1, 0, 2)
        ref = disco_gather_band_contract_ref(
            torch.from_numpy(x), torch.from_numpy(band),
            torch.from_numpy(lat_idx), stride)
        np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=1e-5)

    def test_plan_buffers_carry_the_taps(self):
        _, tp = _plans(PAIRS[0])
        bufs = tp.banded_buffers()
        taps = tdisco.band_live_taps(bufs["psi_band"].numpy())
        for name, a in taps.items():
            assert bufs[name].dtype == torch.from_numpy(a).dtype
            assert np.array_equal(bufs[name].numpy(), a), name
        assert disco_ops.LiveTaps.of(bufs).psi is bufs["tap_psi"]
        rows = tdisco.band_row_taps(tp.lat_idx, taps, tp.grid_in.nlat)
        for name, a in rows.items():
            assert np.array_equal(bufs[name].numpy(), a), name
        assert disco_ops.RowTaps.of(bufs).order is bufs["in_order"]


class TestChunkedApply:
    @pytest.mark.parametrize("layout", ["kernel", "reference"])
    @pytest.mark.parametrize("groups,c_in,c_out,lead", [
        (1, 6, 5, (2,)), (3, 6, 9, (2, 2))])
    def test_chunked_equals_unchunked(self, layout, groups, c_in, c_out,
                                      lead):
        from repro_torch.kernels.config import KernelConfig
        _, tp = _plans(PAIRS[0])
        bufs = tp.buffers(kernels=KernelConfig(disco=layout))
        gen = torch.Generator().manual_seed(0)
        conv = tdisco.DiscoConv(c_out, c_in, tp.n_basis, groups=groups)
        conv.reset(gen)
        conv.bias.normal_(generator=gen)
        x = torch.randn(lead + (c_in, 64, 128), generator=gen)
        whole = conv(x, bufs, tp.stride, chunk_bytes=1 << 40)
        plane = 4 * tp.n_basis * 32 * 64
        for planes in (1, 2, 5):
            part = conv(x, bufs, tp.stride, chunk_bytes=planes * plane)
            np.testing.assert_allclose(part.numpy(), whole.numpy(),
                                       rtol=1e-5, atol=1e-6)
        assert whole.shape == lead + (c_out, 32, 64)

    def test_matches_jax_apply_disco_conv(self):
        jp, tp = _plans(PAIRS[2])
        r = _rng(7)
        w = r.standard_normal((4, 2, 7)).astype(np.float32)
        b = r.standard_normal((4,)).astype(np.float32)
        x = r.standard_normal((3, 4, 33, 64)).astype(np.float32)
        ref = jdisco.apply_disco_conv(
            {"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
            jnp.asarray(x), jp.banded_buffers(), 1, groups=2,
            affine=jp.affine, kernels=PALLAS)
        got = tdisco.apply_disco_conv(
            torch.from_numpy(w), torch.from_numpy(b), torch.from_numpy(x),
            tp.banded_buffers(), 1, groups=2, chunk_bytes=3 * 4 * 7 * 33 * 64)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("groups,c_in,c_out", [(1, 6, 5), (3, 6, 9)])
    def test_checkpointed_gradients_equal_unchunked(self, groups, c_in,
                                                    c_out):
        # with gradients on, each chunk is recomputed in backward; the
        # gradients must not depend on the chunking
        _, tp = _plans(PAIRS[0])
        bufs = tp.banded_buffers()
        gen = torch.Generator().manual_seed(1)
        w = torch.randn((c_out, c_in // groups, tp.n_basis),
                        generator=gen).requires_grad_()
        b = torch.randn((c_out,), generator=gen).requires_grad_()
        x = torch.randn((2, c_in, 64, 128), generator=gen).requires_grad_()
        g = torch.randn((2, c_out, 32, 64), generator=gen)
        plane = 4 * tp.n_basis * 32 * 64
        grads = []
        for chunk in (1 << 40, 2 * plane):
            y = tdisco.apply_disco_conv(w, b, x, bufs, tp.stride, groups,
                                        chunk_bytes=chunk)
            grads.append(torch.autograd.grad(y, (x, w, b), g))
        for got, want in zip(*grads):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
