"""Parity of the port's sphere geometry and transforms with the JAX package.

Geometry is built in float64 numpy by both packages and must be equal
element for element; transforms run the same numpy inputs through both
and are held to the bars of ``tests/test_kernel_dispatch.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import few_torch_threads  # noqa: F401

from repro.configs import fcn3 as jcfgs
from repro.core.sphere import disco as jdisco
from repro.core.sphere import grids as jgrids
from repro.core.sphere import interp as jinterp
from repro.core.sphere import legendre as jleg
from repro.core.sphere import noise as jnoise
from repro.core.sphere import sht as jsht
from repro.evaluation import metrics as jmetrics
from repro.inference import engine as jengine
from repro_torch.core.sphere import disco as tdisco
from repro_torch.core.sphere import grids as tgrids
from repro_torch.core.sphere import interp as tinterp
from repro_torch.core.sphere import legendre as tleg
from repro_torch.core.sphere import noise as tnoise
from repro_torch.core.sphere import sht as tsht
from repro_torch.evaluation import metrics as tmetrics
from repro_torch.inference import engine as tengine


def _grid_pairs(cfg):
    gi = (cfg.nlat, cfg.nlon, cfg.grid)
    gl = (cfg.latent_nlat, cfg.latent_nlon, cfg.latent_grid)
    return [(gi, gl), (gl, gl), (gi, gi)]


SMOKE_PAIRS = _grid_pairs(jcfgs.fcn3_smoke())
SMALL_LATENT = _grid_pairs(jcfgs.fcn3_small())[1]


def _rng(seed):
    return np.random.default_rng(seed)


class TestGeometryExact:
    @pytest.mark.parametrize("spec", [(33, 64, "equiangular"),
                                      (16, 32, "gauss"),
                                      (181, 360, "equiangular")])
    def test_grids(self, spec):
        a, b = jgrids.make_grid(*spec), tgrids.make_grid(*spec)
        for name in ("colat", "lons", "quad_weights"):
            assert np.array_equal(getattr(a, name), getattr(b, name)), name
        assert np.array_equal(a.area_weights_2d(), b.area_weights_2d())

    @pytest.mark.parametrize("spec", [(33, 64, "equiangular"),
                                      (16, 32, "gauss")])
    def test_legendre_tables(self, spec):
        g = jgrids.make_grid(*spec)
        lmax, mmax = g.nlat, min(g.nlat, g.nlon // 2 + 1)
        assert np.array_equal(
            jleg.cached_legendre_table(lmax, mmax, g.colat),
            tleg.cached_legendre_table(lmax, mmax, g.colat))
        jb = jsht.SHT.create(g).buffers()
        tb = tsht.SHT.create(tgrids.make_grid(*spec)).buffers()
        for name in ("wpct", "pct"):
            assert np.array_equal(np.asarray(jb[name]), tb[name].numpy())

    @pytest.mark.parametrize("spec", [(33, 64, "equiangular"),
                                      (16, 32, "gauss")])
    def test_legendre_extents_bound_every_nonzero(self, spec):
        # the extents the Legendre kernel contracts inside: every nonzero
        # of wpct / pct (and of their transposes, flipped) lies in its
        # order's rows and columns, and the bounds are tight
        tb = tsht.SHT.create(tgrids.make_grid(*spec)).buffers()
        r = _rng(1)
        rand = r.standard_normal((20, 17, 6)).astype(np.float32)
        for m in range(6):
            k0, k1, n0, n1 = r.integers(0, 20), r.integers(0, 20), \
                r.integers(0, 17), r.integers(0, 17)
            rand[:min(k0, k1), :, m] = rand[max(k0, k1):, :, m] = 0
            rand[:, :min(n0, n1), m] = rand[:, max(n0, n1):, m] = 0
        rand[:, :, 4] = 0
        rand[r.random(rand.shape) < 0.3] = 0
        cases = [(tb["wpct"].numpy(), tb["wpct_ext"].numpy()),
                 (tb["pct"].numpy(), tb["pct_ext"].numpy()),
                 (rand, tsht.order_extents(rand))]
        for table, ext in cases:
            assert ext.dtype == np.int32 and ext.shape == (2, 2,
                                                           table.shape[2])
            assert np.array_equal(ext, tsht.order_extents(table))
            for t, e in ((table, ext),
                         (table.transpose(1, 0, 2), ext[::-1])):
                assert np.array_equal(e, tsht.order_extents(t))
                for m in range(t.shape[2]):
                    nz_k, nz_n = np.nonzero(t[:, :, m])
                    (k_lo, k_hi), (n_lo, n_hi) = e[:, :, m]
                    if nz_k.size == 0:
                        assert (k_lo, k_hi, n_lo, n_hi) == (0, 0, 0, 0)
                        continue
                    assert (k_lo, k_hi) == (nz_k.min(), nz_k.max() + 1)
                    assert (n_lo, n_hi) == (nz_n.min(), nz_n.max() + 1)
        # the SHT tables are zero for l < m: forward columns, inverse rows
        m = np.arange(tb["wpct"].shape[2])
        assert np.array_equal(tb["wpct_ext"].numpy()[1, 0], m)
        assert np.array_equal(tb["pct_ext"].numpy()[1, 0], m)

    @pytest.mark.parametrize("pair", SMOKE_PAIRS + [SMALL_LATENT],
                             ids=["smoke-enc", "smoke-latent", "smoke-dec",
                                  "small-latent"])
    def test_disco_live_taps_from_the_reference_band(self, pair):
        # the forward kernel's live taps, built from the JAX package's band
        # split, hold exactly its nonzeros and equal the port's own
        gi, go = pair
        jp = jdisco.make_disco_plan(jgrids.make_grid(*gi),
                                    jgrids.make_grid(*go))
        tp = tdisco.make_disco_plan(tgrids.make_grid(*gi),
                                    tgrids.make_grid(*go))
        band = np.asarray(jp._banded_split()[0])
        taps = tdisco.band_live_taps(band)
        k = band.shape[0]
        n_live = int((band != 0).any(axis=(0, 3)).sum())
        assert len(taps["tap_ent"]) == n_live
        assert int((taps["tap_psi"][:, :k] != 0).sum()) == int(
            (band != 0).sum())
        for name, a in tp.live_taps().items():
            assert np.array_equal(a, taps[name]), name

    @pytest.mark.parametrize("pair", SMOKE_PAIRS + [SMALL_LATENT],
                             ids=["smoke-enc", "smoke-latent", "smoke-dec",
                                  "small-latent"])
    def test_disco_plans(self, pair):
        gi, go = pair
        jp = jdisco.make_disco_plan(jgrids.make_grid(*gi),
                                    jgrids.make_grid(*go))
        tp = tdisco.make_disco_plan(tgrids.make_grid(*gi),
                                    tgrids.make_grid(*go))
        assert np.array_equal(jp.psi, tp.psi)
        assert np.array_equal(jp.lat_idx, tp.lat_idx)
        assert jp.affine == tp.affine and jp.stride == tp.stride
        assert jp.n_basis == tp.n_basis
        for a, b in zip(jdisco.split_psi_band(jp.psi),
                        tdisco.split_psi_band(tp.psi)):
            assert np.array_equal(a, b)
        jb, tb = jp.banded_buffers(), tp.banded_buffers()
        for name in ("psi_band", "psi_wrap", "wrap_rows", "lat_idx"):
            assert np.array_equal(np.asarray(jb[name]), tb[name].numpy()), name

    def test_bilinear_plan(self):
        cfg = jcfgs.fcn3_smoke()
        gl = (cfg.latent_nlat, cfg.latent_nlon, cfg.latent_grid)
        gi = (cfg.nlat, cfg.nlon, cfg.grid)
        a = jinterp.BilinearResample.create(jgrids.make_grid(*gl),
                                            jgrids.make_grid(*gi))
        b = tinterp.BilinearResample.create(tgrids.make_grid(*gl),
                                            tgrids.make_grid(*gi))
        for name in ("lat_idx0", "lat_w", "lon_idx0", "lon_w"):
            assert np.array_equal(getattr(a, name), getattr(b, name)), name

    def test_noise_sigma_and_power_law(self):
        g = (33, 64, "equiangular")
        js = jnoise.SphericalDiffusion(jsht.SHT.create(jgrids.make_grid(*g)))
        ts = tnoise.SphericalDiffusion(tsht.SHT.create(tgrids.make_grid(*g)))
        assert np.array_equal(js._sigma_l(), ts.sigma_l())
        assert np.array_equal(jnoise.power_law_sigma_l(33),
                              tnoise.power_law_sigma_l(33))
        assert np.array_equal(jsht.mode_mask(9, 5), tsht.mode_mask(9, 5))


class TestTransforms:
    @pytest.fixture(scope="class")
    def shts(self):
        g = (32, 64, "gauss")
        j = jsht.SHT.create(jgrids.make_grid(*g))
        t = tsht.SHT.create(tgrids.make_grid(*g))
        return j, j.buffers(), t, t.buffers()

    def test_sht_forward_inverse(self, shts):
        j, jb, t, tb = shts
        x = _rng(0).standard_normal((3, 32, 64)).astype(np.float32)
        cj = j.forward(jnp.asarray(x), jb)
        ct = t.forward(torch.from_numpy(x), tb)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
        c = np.asarray(cj)
        np.testing.assert_allclose(
            t.inverse(torch.from_numpy(c), tb).numpy(),
            np.asarray(j.inverse(jnp.asarray(c), jb)), atol=1e-4)

    def test_spectrum(self, shts):
        j, jb, t, tb = shts
        x = _rng(1).standard_normal((2, 32, 64)).astype(np.float32)
        c = np.asarray(j.forward(jnp.asarray(x), jb))
        np.testing.assert_allclose(
            tsht.spectrum(torch.from_numpy(c)).numpy(),
            np.asarray(jsht.spectrum(jnp.asarray(c))), rtol=1e-5, atol=1e-6)

    def test_disco_fft_reference(self):
        gi, go = SMOKE_PAIRS[0]
        jp = jdisco.make_disco_plan(jgrids.make_grid(*gi),
                                    jgrids.make_grid(*go))
        tp = tdisco.make_disco_plan(tgrids.make_grid(*gi),
                                    tgrids.make_grid(*go))
        x = _rng(2).standard_normal((2, gi[0], gi[1])).astype(np.float32)
        ref = jdisco.disco_conv(jnp.asarray(x), jnp.asarray(jp.psi),
                                jnp.asarray(jp.lat_idx), jp.stride, jp.affine)
        tb = tp.buffers(kernels=None)
        got = tdisco.disco_conv(torch.from_numpy(x), torch.from_numpy(tp.psi),
                                torch.from_numpy(tp.lat_idx), tp.stride)
        assert "psi_band" in tb  # default KernelConfig is the kernel layout
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    def test_bilinear_upsample(self):
        cfg = jcfgs.fcn3_smoke()
        gl = (cfg.latent_nlat, cfg.latent_nlon, cfg.latent_grid)
        gi = (cfg.nlat, cfg.nlon, cfg.grid)
        a = jinterp.BilinearResample.create(jgrids.make_grid(*gl),
                                            jgrids.make_grid(*gi))
        b = tinterp.BilinearResample.create(tgrids.make_grid(*gl),
                                            tgrids.make_grid(*gi))
        x = _rng(3).standard_normal((2, 3, 16, 32)).astype(np.float32)
        np.testing.assert_allclose(b(torch.from_numpy(x)).numpy(),
                                   np.asarray(a(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)

    def test_noise_to_grid_and_centering(self):
        g = (33, 64, "equiangular")
        js = jnoise.SphericalDiffusion(jsht.SHT.create(jgrids.make_grid(*g)))
        ts = tnoise.SphericalDiffusion(tsht.SHT.create(tgrids.make_grid(*g)))
        r = _rng(4)
        shape = (4, 8, 33, 33)
        z = (r.standard_normal(shape)
             + 1j * r.standard_normal(shape)).astype(np.complex64)
        zt = ts.to_grid(torch.from_numpy(z), ts.buffers())
        zj = js.to_grid(jnp.asarray(z), js.buffers())
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-4)
        np.testing.assert_array_equal(
            tnoise.center_noise(zt, 0).numpy(),
            np.asarray(jnoise.center_noise(jnp.asarray(zt.numpy()), 0)))

    def test_generator_noise_statistics(self):
        # the port's own draws cannot match threefry; hold their moments:
        # m = 0 real N(0,1), m > 0 complex with Re, Im ~ N(0, 1/2)
        g = torch.Generator().manual_seed(0)
        sig = torch.ones(64)
        c = tnoise.sample_spectral_coeffs(g, (400,), sig, 64, 33)
        mask = torch.from_numpy(tsht.mode_mask(64, 33))
        m0 = c[:, :, 0][:, mask[:, 0]]
        assert float(m0.imag.abs().max()) == 0.0
        assert abs(float(m0.real.var()) - 1.0) < 0.02
        mp = c[:, :, 1:][:, mask[:, 1:]]
        assert abs(float(mp.real.var()) - 0.5) < 0.01
        assert abs(float(mp.imag.var()) - 0.5) < 0.01
        assert float(c[:, ~mask].abs().max()) == 0.0


class TestScores:
    @pytest.fixture(scope="class")
    def fields(self):
        r = _rng(5)
        ens = r.standard_normal((4, 3, 33, 64)).astype(np.float32)
        truth = r.standard_normal((3, 33, 64)).astype(np.float32)
        aw = jgrids.make_grid(33, 64).area_weights_2d().astype(np.float32)
        return ens, truth, aw

    @pytest.mark.parametrize("name", ["crps", "ensemble_skill", "ssr",
                                      "spread"])
    def test_engine_scores(self, fields, name):
        ens, truth, aw = fields
        fns = {
            "crps": (jmetrics.crps, tmetrics.crps, True),
            "ensemble_skill": (jmetrics.ensemble_skill,
                               tmetrics.ensemble_skill, True),
            "ssr": (jmetrics.spread_skill_ratio,
                    tmetrics.spread_skill_ratio, True),
            "spread": (jmetrics.ensemble_spread, tmetrics.ensemble_spread,
                       False),
        }
        jf, tf, with_truth = fns[name]
        jargs = ((jnp.asarray(ens), jnp.asarray(truth)) if with_truth
                 else (jnp.asarray(ens),))
        targs = ((torch.from_numpy(ens), torch.from_numpy(truth))
                 if with_truth else (torch.from_numpy(ens),))
        np.testing.assert_allclose(
            tf(*targs, torch.from_numpy(aw)).numpy(),
            np.asarray(jf(*jargs, jnp.asarray(aw))), rtol=1e-5, atol=1e-6)

    def test_crps_forms(self, fields):
        from repro.core import crps as jcrps
        from repro_torch.core import crps as tcrps
        ens, truth, _ = fields
        for fair in (False, True):
            np.testing.assert_allclose(
                tcrps.crps_ensemble(torch.from_numpy(ens),
                                    torch.from_numpy(truth),
                                    fair=fair).numpy(),
                np.asarray(jcrps.crps_ensemble(jnp.asarray(ens),
                                               jnp.asarray(truth),
                                               fair=fair)),
                rtol=1e-5, atol=1e-6)

    def test_rank_histograms(self, fields):
        ens, truth, aw = fields
        ref = np.asarray(jengine.in_scan_rank_histogram(
            jnp.asarray(ens), jnp.asarray(truth), jnp.asarray(aw)))
        got = tengine.in_scan_rank_histogram(
            torch.from_numpy(ens), torch.from_numpy(truth),
            torch.from_numpy(aw)).numpy()
        per_ch = tmetrics.rank_histogram_per_channel(
            torch.from_numpy(ens), torch.from_numpy(truth),
            torch.from_numpy(aw)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got, per_ch)
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)

    def test_spatial_mean_matches_reference(self, fields):
        # unnormalized weights: the ones-denominator renormalizes them
        ens, _, aw = fields
        w = 3.0 * aw
        np.testing.assert_allclose(
            tmetrics._spatial_mean(torch.from_numpy(ens),
                                   torch.from_numpy(w)).numpy(),
            np.asarray(jmetrics._spatial_mean(jnp.asarray(ens),
                                              jnp.asarray(w))),
            rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The extras: buffer specs, resampling, the spectral filter's modes
# ---------------------------------------------------------------------------

def _jdtype(d) -> str:
    return str(np.dtype(d))


def _tdtype(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


class TestExtras:
    def test_sht_buffer_specs_match_jax_and_buffers(self):
        g = (16, 32, "gauss")
        j = jsht.SHT.create(jgrids.make_grid(*g)).buffer_specs()
        t = tsht.SHT.create(tgrids.make_grid(*g))
        specs = t.buffer_specs()
        assert all(s.device.type == "meta" for s in specs.values())
        for k, want in j.items():
            assert tuple(specs[k].shape) == want.shape, k
            assert _tdtype(specs[k]) == _jdtype(want.dtype), k
        bufs = t.buffers()
        assert set(specs) == set(bufs)
        for k, b in bufs.items():
            assert (specs[k].shape, specs[k].dtype) == (b.shape, b.dtype), k

    @pytest.mark.parametrize("layout", ["reference", "kernel"])
    def test_disco_buffer_specs_match_jax_and_buffers(self, layout):
        from repro.kernels.config import KernelConfig as JKC
        from repro_torch.kernels.config import KernelConfig as TKC
        gi, go = SMOKE_PAIRS[0]
        jplan = jdisco.make_disco_plan(jgrids.make_grid(*gi),
                                       jgrids.make_grid(*go))
        tplan = tdisco.make_disco_plan(tgrids.make_grid(*gi),
                                       tgrids.make_grid(*go))
        jk = (JKC() if layout == "reference"
              else JKC(sht="pallas", disco="pallas", interpret=True))
        tk = TKC(sht=layout, disco=layout)
        want = jplan.buffer_specs(kernels=jk)
        specs = tplan.buffer_specs(tk)
        for k, w in want.items():
            assert tuple(specs[k].shape) == w.shape, k
            # the port keeps its wrap rows as int64 index tensors
            if k != "wrap_rows":
                assert _tdtype(specs[k]) == _jdtype(w.dtype), k
        bufs = tplan.buffers("cpu", tk)
        assert set(specs) == set(bufs)
        for k, b in bufs.items():
            assert (specs[k].shape, specs[k].dtype) == (b.shape, b.dtype), k

    @pytest.mark.parametrize("src,dst", [
        ((16, 32, "gauss"), (33, 64, "equiangular")),
        ((33, 64, "equiangular"), (16, 32, "gauss"))], ids=["up", "down"])
    def test_resample_matches_jax(self, src, dst):
        x = _rng(5).standard_normal((2, 3) + src[:2]).astype(np.float32)
        want = jsht.resample(jnp.asarray(x),
                             jsht.SHT.create(jgrids.make_grid(*src)),
                             jsht.SHT.create(jgrids.make_grid(*dst)))
        got = tsht.resample(torch.from_numpy(x),
                            tsht.SHT.create(tgrids.make_grid(*src)),
                            tsht.SHT.create(tgrids.make_grid(*dst)))
        assert tuple(got.shape) == (2, 3) + dst[:2]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)

    @pytest.mark.parametrize("mode,lmax_keep", [
        ("depthwise", None), ("depthwise", 9), ("full", 9)])
    def test_spectral_conv_modes_match_jax(self, mode, lmax_keep):
        import jax
        from repro.core.sphere import spectral_conv as jspec
        from repro_torch.core.sphere import spectral_conv as tspec
        from repro_torch.kernels.config import KernelConfig as TKC
        g = (16, 32, "gauss")
        jt = jsht.SHT.create(jgrids.make_grid(*g))
        tt = tsht.SHT.create(tgrids.make_grid(*g))
        c, lmax = 4, jt.lmax
        params = jspec.init_spectral_filter(jax.random.PRNGKey(3), c, c,
                                            lmax, mode=mode)
        if mode == "depthwise":   # move the gain off its ones
            params = {"w": params["w"] + jnp.asarray(
                _rng(6).standard_normal((c, lmax)), jnp.float32)}
        x = _rng(7).standard_normal((2, c) + g[:2]).astype(np.float32)
        want = jspec.apply_spectral_conv(params, jnp.asarray(x),
                                         jt.buffers(), g[1],
                                         lmax_keep=lmax_keep)
        filt = tspec.SpectralFilter(c, c, lmax, mode=mode)
        if mode == "depthwise":
            assert torch.equal(filt.w, torch.ones(c, lmax))
        with torch.no_grad():
            for k, v in params.items():
                getattr(filt, k).copy_(torch.from_numpy(np.array(v)))
        got = filt(torch.from_numpy(x), tt.buffers(), g[1],
                   TKC(sht="reference"), lmax_keep=lmax_keep)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)

    def test_depthwise_needs_equal_channels(self):
        from repro_torch.core.sphere import spectral_conv as tspec
        with pytest.raises(ValueError, match="c_out == c_in"):
            tspec.SpectralFilter(3, 4, 8, mode="depthwise")
