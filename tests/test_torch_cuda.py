"""The hand-written CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU or interpret mode).  The file imports no JAX, so it
runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.sphere import disco as tdisco
from repro_torch.core.sphere import grids as tgrids
from repro_torch.core.sphere import sht as tsht
from repro_torch.kernels import dispatch
from repro_torch.kernels.crps import ops as crps_ops
from repro_torch.kernels.crps.ref import crps_fused_bwd_ref, crps_fused_ref
from repro_torch.kernels.disco import ops as disco_ops
from repro_torch.kernels.disco.ref import (disco_band_transpose_ref,
                                           disco_gather_band_contract_ref)
from repro_torch.kernels.legendre import ops as legendre_ops
from repro_torch.kernels.legendre.ref import legendre_contract_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import (chunk_recurrence_ref,
                                         ssd_intra_chunk_ref)

PAIRS = [((64, 128, "equiangular"), (32, 64, "gauss")),   # encoder, stride 2
         ((16, 32, "gauss"), (16, 32, "gauss")),          # latent block
         ((33, 64, "equiangular"), (33, 64, "equiangular"))]  # decoder
PAIR_IDS = ["enc", "latent", "dec"]


#: kernel vs plain: max |kernel - plain| <= REL_TOL * max |plain|, as in
#: chip_smoke.py; one plain TF32 product (~2^-11 relative) misses it
REL_TOL = 1e-4


def _plan(pair):
    gi, go = pair
    return tdisco.make_disco_plan(tgrids.make_grid(*gi), tgrids.make_grid(*go))


def _extents(table):
    """The table's order extents, built by the numpy builder."""
    return torch.from_numpy(
        tsht.order_extents(table.cpu().numpy())).to(table.device)


def _taps(psi):
    """psi's live taps, built by the numpy builder."""
    return disco_ops.LiveTaps.of({
        k: torch.from_numpy(v).to(psi.device)
        for k, v in tdisco.band_live_taps(psi.cpu().numpy()).items()})


def _spread(shape, gen, device):
    """Values of both signs with magnitudes spread over 1e-3 .. 1e3."""
    mag = 10.0 ** (6 * torch.rand(shape, generator=gen, device=device) - 3)
    sign = torch.randint(0, 2, shape, generator=gen, device=device) * 2 - 1
    return mag * sign


def _tf32(t):
    """t rounded to TF32 (10-bit mantissa), as one plain TF32 product
    would read it."""
    u = t.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _rel_err(got, ref):
    return float((got - ref).abs().max()) / float(ref.abs().max())


# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.runtime import set_precision
    set_precision()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64],
                         ids=["real", "complex"])
@pytest.mark.parametrize("b,k,n,m", [(3, 16, 16, 9), (130, 70, 65, 33)])
def test_cuda_legendre_kernel(cuda, b, k, n, m, dtype, transposed):
    # the SHT's calls read complex x in place, and the inverse passes its
    # table as a transposed view
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((b, k, m), generator=gen, device=cuda, dtype=dtype)
    t = torch.randn((n, k, m) if transposed else (k, n, m), generator=gen,
                    device=cuda)
    if transposed:
        t = t.permute(1, 0, 2)
    before = legendre_ops.launches
    got = legendre_ops.legendre_contract(x, t, _extents(t))
    torch.cuda.synchronize()
    assert legendre_ops.launches == before + 1
    assert got.dtype == dtype
    torch.testing.assert_close(got, legendre_contract_ref(x, t),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64],
                         ids=["real", "complex"])
def test_cuda_legendre_kernel_sht_tables(cuda, dtype, transposed):
    # the SHT's own triangular tables (zero for l < m): forward wpct, and
    # pct as the inverse's transposed view with its flipped extents
    buf = tsht.SHT.create(tgrids.make_grid(48, 96, "gauss")).buffers(cuda)
    if transposed:
        t, ext = buf["pct"].permute(1, 0, 2), buf["pct_ext"].flip(0)
    else:
        t, ext = buf["wpct"], buf["wpct_ext"]
    assert torch.equal(ext, _extents(t))
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((77, t.shape[0], t.shape[2]), generator=gen, device=cuda,
                    dtype=dtype)
    got = legendre_ops.legendre_contract(x, t, ext)
    ref = legendre_contract_ref(x, t)
    assert _rel_err(got, ref) <= REL_TOL
    assert torch.equal(got, legendre_ops.legendre_contract(x, t, ext))


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["vec", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64],
                         ids=["real", "complex"])
def test_cuda_legendre_kernel_ragged_spread(cuda, dtype, aligned):
    # a table that is not triangular: per order a random block of rows
    # and columns, scattered zeros inside it, one all-zero order; values
    # spread over 1e-3..1e3, where one plain TF32 product misses the bar
    gen = torch.Generator(device=cuda).manual_seed(8)
    k, n, m = 72, 90, 12
    t = _spread((k, n, m), gen, cuda)
    for mm in range(m):
        k0, k1 = sorted(torch.randint(0, k, (2,), generator=gen,
                                      device=cuda).tolist())
        n0, n1 = sorted(torch.randint(0, n, (2,), generator=gen,
                                      device=cuda).tolist())
        t[:k0, :, mm] = t[k1:, :, mm] = 0
        t[:, :n0, mm] = t[:, n1:, mm] = 0
    t[:, :, 5] = 0
    t[torch.rand(t.shape, generator=gen, device=cuda) < 0.2] = 0
    if dtype == torch.complex64:
        x = torch.complex(_spread((61, k, m + 1), gen, cuda),
                          _spread((61, k, m + 1), gen, cuda))
    else:
        x = _spread((61, k, m + 1), gen, cuda)
    x = x[..., 1:] if not aligned else x[..., :m]   # unaligned: offset 1
    ext = _extents(t)
    got = legendre_ops.legendre_contract(x, t, ext)
    ref = legendre_contract_ref(x, t)
    assert _rel_err(got, ref) <= REL_TOL
    xr = torch.view_as_real(x) if x.is_complex() else x
    one = legendre_contract_ref(
        torch.view_as_complex(_tf32(xr)) if x.is_complex() else _tf32(xr),
        _tf32(t))
    assert _rel_err(one, ref) > REL_TOL          # the bar tells TF32 apart
    assert torch.equal(got, legendre_ops.legendre_contract(x, t, ext))


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_cuda_disco_band_kernel(cuda, pair):
    tp = _plan(pair)
    tb = tp.banded_buffers(cuda)
    gi = pair[0]
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((11, gi[0], gi[1]), generator=gen, device=cuda)
    before = disco_ops.launches
    got = disco_ops.disco_band_contract(x, tb["psi_band"], tb["lat_idx"],
                                        disco_ops.LiveTaps.of(tb), tp.stride)
    torch.cuda.synchronize()
    assert disco_ops.launches == before + 1
    ref = disco_gather_band_contract_ref(x, tb["psi_band"], tb["lat_idx"],
                                         tp.stride)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("w_out", [60, 62], ids=["w60", "w62"])
@pytest.mark.parametrize("stride", [1, 2, 3, 4])
def test_cuda_disco_band_kernel_random_psi(cuda, stride, w_out):
    # psi that is not banded the usual way: scattered interior zeros,
    # dead slices and a dead row, any lat_idx; x spread over 1e-3..1e3,
    # where one plain TF32 product misses the bar
    gen = torch.Generator(device=cuda).manual_seed(9 + stride)
    k, h_out, s, d, h_in = 7, 13, 5, 23, 17
    psi = _spread((k, h_out, s, d), gen, cuda)
    psi[torch.rand(psi.shape, generator=gen, device=cuda) < 0.3] = 0
    psi[:, 2, 1] = 0
    psi[:, 4] = 0
    psi[..., :3] = 0
    lat_idx = torch.randint(0, h_in, (h_out, s), generator=gen, device=cuda,
                            dtype=torch.int32)
    x = _spread((19, h_in, w_out * stride), gen, cuda)
    taps = _taps(psi)
    got = disco_ops.disco_band_contract(x, psi, lat_idx, taps, stride)
    ref = disco_gather_band_contract_ref(x, psi, lat_idx, stride)
    assert _rel_err(got, ref) <= REL_TOL
    one = disco_gather_band_contract_ref(_tf32(x), _tf32(psi), lat_idx,
                                         stride)
    assert _rel_err(one, ref) > REL_TOL
    assert torch.equal(got, disco_ops.disco_band_contract(x, psi, lat_idx,
                                                          taps, stride))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_inputs(cuda):
    x = torch.zeros((2, 4, 3), device=cuda, dtype=torch.float64)
    ext = torch.zeros((2, 2, 3), device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError):
        legendre_ops.legendre_contract(x, torch.zeros((4, 5, 3), device=cuda,
                                                      dtype=torch.float64),
                                       ext)
    with pytest.raises(ValueError):
        legendre_ops.legendre_contract(x.float(), torch.zeros((3, 5, 3),
                                                              device=cuda),
                                       ext)
    with pytest.raises(ValueError):   # m must have unit stride
        legendre_ops.legendre_contract(
            x.float(), torch.zeros((3, 5, 4), device=cuda).permute(2, 1, 0),
            ext)
    with pytest.raises(ValueError):   # extents of another order count
        legendre_ops.legendre_contract(
            x.float(), torch.zeros((4, 5, 3), device=cuda), ext[..., :2])
    with pytest.raises(TypeError):    # extents are int32
        legendre_ops.legendre_contract(
            x.float(), torch.zeros((4, 5, 3), device=cuda), ext.long())
    tp = _plan(PAIRS[1])
    tb = tp.banded_buffers(cuda)
    taps = disco_ops.LiveTaps.of(tb)
    with pytest.raises(ValueError):
        disco_ops.disco_band_contract(
            torch.zeros((2, 16, 32), device=cuda), tb["psi_band"].cpu(),
            tb["lat_idx"], taps, 1)
    with pytest.raises(ValueError):   # live taps of another psi
        disco_ops.disco_band_contract(
            torch.zeros((2, 16, 32), device=cuda), tb["psi_band"],
            tb["lat_idx"], taps._replace(ptr=taps.ptr[:-1]), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_cuda_disco_band_transpose_kernel(cuda, pair):
    tp = _plan(pair)
    tb = tp.banded_buffers(cuda)
    h_in, w_in = pair[0][:2]
    k, h_out = tb["psi_band"].shape[:2]
    gen = torch.Generator(device=cuda).manual_seed(2)
    g = torch.randn((11, k, h_out, w_in // tp.stride), generator=gen,
                    device=cuda)
    args = (tb["psi_band"], tb["lat_idx"], disco_ops.LiveTaps.of(tb),
            disco_ops.RowTaps.of(tb), h_in, tp.stride)
    before = disco_ops.transpose_launches
    got = disco_ops.disco_band_transpose(g, *args)
    again = disco_ops.disco_band_transpose(g, *args)
    torch.cuda.synchronize()
    assert disco_ops.transpose_launches == before + 2
    assert torch.equal(got, again)          # no atomics: deterministic
    ref = disco_band_transpose_ref(g, tb["psi_band"], tb["lat_idx"], h_in,
                                   tp.stride)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("w_out", [30, 31, 61], ids=["w30", "w31", "w61"])
@pytest.mark.parametrize("stride", [1, 2, 3, 4])
def test_cuda_disco_band_transpose_kernel_random_psi(cuda, stride, w_out):
    # psi with scattered interior zeros, dead slices and a dead row, one
    # slice wider than a staged piece, any lat_idx, odd widths (4-byte
    # copies) and a window wider than the circle; g spread over
    # 1e-3..1e3, where one plain TF32 product misses the bar.  Strides 3
    # and 4 take the kernel's generic path (one residue class a block)
    gen = torch.Generator(device=cuda).manual_seed(19 + stride + w_out)
    k, h_out, s, d, h_in = 7, 13, 5, 151, 17
    psi = _spread((k, h_out, s, d), gen, cuda)
    psi[torch.rand(psi.shape, generator=gen, device=cuda) < 0.3] = 0
    psi[..., :60] = 0
    psi[..., 90:] = 0
    psi[:, 3, 2, 5:148] = _spread((k, 143), gen, cuda)   # 143 taps
    psi[:, 2, 1] = 0
    psi[:, 4] = 0
    lat_idx = torch.randint(0, h_in, (h_out, s), generator=gen, device=cuda,
                            dtype=torch.int32)
    g = _spread((19, k, h_out, w_out), gen, cuda)
    taps = _taps(psi)
    rows = disco_ops.RowTaps(*(
        torch.from_numpy(a).to(cuda) for a in tdisco.band_row_taps(
            lat_idx.cpu().numpy(), tdisco.band_live_taps(psi.cpu().numpy()),
            h_in).values()))
    before = disco_ops.transpose_launches
    got = disco_ops.disco_band_transpose(g, psi, lat_idx, taps, rows, h_in,
                                         stride)
    again = disco_ops.disco_band_transpose(g, psi, lat_idx, taps, rows,
                                           h_in, stride)
    torch.cuda.synchronize()
    assert disco_ops.transpose_launches == before + 2
    assert torch.equal(got, again)          # no atomics: deterministic
    ref = disco_band_transpose_ref(g, psi, lat_idx, h_in, stride)
    assert _rel_err(got, ref) <= REL_TOL
    one = disco_band_transpose_ref(_tf32(g), _tf32(psi), lat_idx, h_in,
                                   stride)
    assert _rel_err(one, ref) > REL_TOL


@pytest.mark.cuda
def test_cuda_transpose_refuses_bad_inputs(cuda):
    tp = _plan(PAIRS[1])
    tb = tp.banded_buffers(cuda)
    taps, rows = disco_ops.LiveTaps.of(tb), disco_ops.RowTaps.of(tb)
    g = torch.zeros((2, 7, 16, 32), device=cuda)
    args = (tb["psi_band"], tb["lat_idx"], taps, rows, 16)
    with pytest.raises(ValueError):   # no stride below 1
        disco_ops.disco_band_transpose(torch.zeros((2, 7, 16, 32),
                                                   device=cuda), *args, 0)
    with pytest.raises(ValueError):   # lists of another input grid
        disco_ops.disco_band_transpose(g, *args[:-1], 15, 1)
    with pytest.raises(TypeError):
        disco_ops.disco_band_transpose(g.double(), *args, 1)
    with pytest.raises(ValueError):   # lists on the host
        disco_ops.disco_band_transpose(
            g, *args[:3], rows._replace(ent=rows.ent.cpu()), 16, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("fair", [False, True], ids=["biased", "fair"])
@pytest.mark.parametrize("e,n", [(1, 1000), (2, 77777), (5, 300),
                                 (16, 4099)])
def test_cuda_crps_kernels(cuda, e, n, fair):
    gen = torch.Generator(device=cuda).manual_seed(e)
    ens = torch.randn((e, n), generator=gen, device=cuda)
    obs = torch.randn((n,), generator=gen, device=cuda)
    g = torch.randn((n,), generator=gen, device=cuda)
    ens[:, :7] = ens[0, :7].clone()         # ties: sgn(0) = 0 in both
    obs[:3] = ens[0, :3]
    before = (crps_ops.launches, crps_ops.bwd_launches)
    got = crps_ops.crps_fused(ens, obs, fair)
    grad = crps_ops.crps_fused_bwd(g, ens, obs, fair)
    torch.cuda.synchronize()
    assert (crps_ops.launches, crps_ops.bwd_launches) == (before[0] + 1,
                                                          before[1] + 1)
    torch.testing.assert_close(got, crps_fused_ref(ens, obs, fair),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grad, crps_fused_bwd_ref(g, ens, obs, fair),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("e,ranks", [(2, 2), (3, 2), (4, 4)],
                         ids=["E2-R2", "E3-R2", "E4-R4"])
def test_cuda_dist_crps_channels_kernel(cuda, e, ranks):
    # the engine's scores across ranks: members gathered on each rank's
    # ragged block of points, the CRPS kernel there, per-channel sums
    # psummed; against the plain version over the whole field
    import _torch_dist_workers as workers
    from repro_torch.distributed.world import run_world
    from repro_torch.kernels import build
    build.load_library("crps")     # built once, before the ranks load it
    res = run_world(workers.crps_channels_rank, ranks,
                    ({"shape": (e, 3, 1001)},), timeout=300.0)
    for r in res:
        assert r["launches"] == 1
        err = np.abs(r["got"] - r["want"]).max()
        assert err <= 1e-4 * np.abs(r["want"]).max(), err


@pytest.mark.cuda
def test_cuda_crps_refuses_too_many_members(cuda):
    ens = torch.zeros((crps_ops.MAX_MEMBERS + 1, 8), device=cuda)
    with pytest.raises(ValueError, match="MAX_MEMBERS"):
        crps_ops.crps_fused(ens, torch.zeros((8,), device=cuda))


@pytest.mark.cuda
def test_cuda_backward_runs_kernels(cuda):
    # the autograd functions' backward launches the kernels and agrees
    # with autograd through the plain versions on the same card
    tp = _plan(PAIRS[0])
    tb = tp.banded_buffers(cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((3, 64, 128), generator=gen, device=cuda,
                    requires_grad=True)
    before = disco_ops.transpose_launches
    out = dispatch._BandContract.apply(x, tb["psi_band"], tb["lat_idx"],
                                       disco_ops.LiveTaps.of(tb),
                                       disco_ops.RowTaps.of(tb), tp.stride)
    (gx,) = torch.autograd.grad(out.square().sum(), x)
    xr = x.detach().clone().requires_grad_()
    ref = disco_gather_band_contract_ref(xr, tb["psi_band"], tb["lat_idx"],
                                         tp.stride)
    (gr,) = torch.autograd.grad(ref.square().sum(), xr)
    assert disco_ops.transpose_launches == before + 1
    torch.testing.assert_close(gx, gr, rtol=1e-4, atol=1e-4)

    xc = torch.randn((4, 16, 9), generator=gen, device=cuda,
                     dtype=torch.complex64, requires_grad=True)
    t = torch.randn((16, 12, 9), generator=gen, device=cuda)
    before = legendre_ops.launches
    (gl,) = torch.autograd.grad(
        dispatch._Legendre.apply(xc, t, _extents(t)).abs().square().sum(),
        xc)
    assert legendre_ops.launches == before + 2
    xr = xc.detach().clone().requires_grad_()
    (glr,) = torch.autograd.grad(
        legendre_contract_ref(xr, t).abs().square().sum(), xr)
    torch.testing.assert_close(gl, glr, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# SSD intra-chunk kernel
# ---------------------------------------------------------------------------

#: (BC, L, H, P, G, N): tests/test_kernels_ssd.py's four shapes, G = 4,
#: BC = 1 at the mamba2-130m tile, and 16 chunks of the prefill shape
SSD_SHAPES = [(2, 16, 4, 8, 1, 16), (3, 32, 6, 16, 2, 8), (1, 8, 2, 4, 2, 4),
              (4, 128, 8, 64, 1, 128), (2, 64, 8, 32, 4, 64),
              (1, 128, 24, 64, 1, 128), (16, 128, 24, 64, 1, 128)]


def _ssd_inputs(shape, device, da_scale=0.1, seed=0):
    bc, l, h, p, g, n = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device=device)

    da = -randn(bc, l, h).abs() * da_scale
    return (randn(bc, l, h, p), torch.cumsum(da, dim=1), randn(bc, l, g, n),
            randn(bc, l, g, n))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=[str(s) for s in SSD_SHAPES])
def test_cuda_ssd_kernel(cuda, shape):
    ins = _ssd_inputs(shape, cuda)
    before = ssd_ops.launches
    y, st = ssd_ops.ssd_intra_chunk(*ins)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    y_ref, st_ref = ssd_intra_chunk_ref(*ins)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_ssd_kernel_large_decay_is_finite(cuda):
    # chunk |dA| sums far above 88: exp(cs_l - cs_s) above the diagonal
    # would overflow; the kernel masks before exp
    ins = _ssd_inputs((4, 128, 24, 64, 1, 128), cuda, da_scale=2.0, seed=1)
    assert float(ins[1][:, -1].abs().min()) > 88.0
    y, st = ssd_ops.ssd_intra_chunk(*ins)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    y_ref, st_ref = ssd_intra_chunk_ref(*ins)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_ssd_kernel_is_deterministic(cuda):
    ins = _ssd_inputs((8, 128, 24, 64, 1, 128), cuda, seed=2)
    y1, s1 = ssd_ops.ssd_intra_chunk(*ins)
    y2, s2 = ssd_ops.ssd_intra_chunk(*ins)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 52, 16, 2, 32),
                                   (2, 100, 6, 7, 3, 13)],
                         ids=["tiles", "odd"])
def test_cuda_ssd_kernel_head_tiles_and_odd_shapes(cuda, shape):
    # more heads a group than a block takes (26 = 24 + 2: two head tiles,
    # the second ragged), and P and N that are not multiples of 4 (4-byte
    # copies, ragged fragments)
    ins = _ssd_inputs(shape, cuda, da_scale=0.5, seed=len(shape))
    y, st = ssd_ops.ssd_intra_chunk(*ins)
    torch.cuda.synchronize()
    y_ref, st_ref = ssd_intra_chunk_ref(*ins)
    assert _rel_err(y, y_ref) <= REL_TOL
    assert _rel_err(st, st_ref) <= REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 256, 24, 64, 128), (3, 5, 2, 3, 5),
                                   (1, 1, 4, 8, 16)],
                         ids=["prefill", "odd", "one-chunk"])
def test_cuda_chunk_recurrence_kernel(cuda, shape):
    # the kernel takes one fused multiply-add a step where the plain
    # loop's addcmul may round twice: a few ulps a step, damped by the
    # decays (< 1), so 1e-6 of max |plain| rather than bitwise
    from repro_torch.kernels.ssd.ref import chunk_recurrence_ref
    bsz, nc, h, p, n = shape
    gen = torch.Generator(device=cuda).manual_seed(nc)
    states = torch.randn(shape, generator=gen, device=cuda)
    decay = torch.rand((bsz, nc, h), generator=gen, device=cuda) * 0.9 + 0.1
    init = torch.randn((bsz, h, p, n), generator=gen, device=cuda)
    before = ssd_ops.state_launches
    prev, final = ssd_ops.chunk_recurrence(states, decay, init)
    again = ssd_ops.chunk_recurrence(states, decay, init)
    torch.cuda.synchronize()
    assert ssd_ops.state_launches == before + 2
    assert torch.equal(prev, again[0]) and torch.equal(final, again[1])
    prev_ref, final_ref = chunk_recurrence_ref(states, decay, init)
    assert torch.equal(prev[:, 0], init)
    assert _rel_err(prev, prev_ref) <= 1e-6
    assert _rel_err(final, final_ref) <= 1e-6
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.chunk_recurrence(states.detach(), decay,
                                 init.transpose(-1, -2).contiguous()
                                 .transpose(-1, -2))


@pytest.mark.cuda
def test_cuda_ssd_refuses_grad_and_bad_inputs(cuda):
    # an input that requires grad is no longer refused: the forward
    # launches, and its backward is the backward kernel
    x, da_cs, b, c = _ssd_inputs((2, 16, 4, 8, 1, 16), cuda)
    before = ssd_ops.launches, ssd_ops.bwd_launches
    y, st = ssd_ops.ssd_intra_chunk(x.requires_grad_(), da_cs, b, c)
    (y.sum() + st.sum()).backward()
    assert (ssd_ops.launches, ssd_ops.bwd_launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert x.grad is not None and torch.isfinite(x.grad).all()
    x = x.detach()
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd_intra_chunk(x.transpose(1, 2).contiguous()
                                .transpose(1, 2), da_cs, b, c)
    with pytest.raises(ValueError, match="must be on"):
        ssd_ops.ssd_intra_chunk(x, da_cs.cpu(), b, c)
    big = _ssd_inputs((1, 256, 2, 8, 1, 8), cuda)
    with pytest.raises(ValueError, match="L <= 128"):
        ssd_ops.ssd_intra_chunk(*big)


#: the gradient bar of tests/test_kernel_dispatch.py's grad-parity test
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
#: (BC, L, H, P, G, N) of the backward kernels: small, two groups with a
#: ragged L, P and N, zamba2-2.7b's 80 heads a group (past the forward's
#: head tile of 24), the mamba2-130m tile
SSD_BWD_SHAPES = [(2, 16, 4, 8, 1, 16), (3, 100, 6, 40, 2, 72),
                  (2, 128, 80, 64, 1, 64), (4, 128, 24, 64, 1, 128)]


def _intra_grads_ref(ins, dy, dst):
    # autograd of the plain version in float64: the float32 plain version
    # rounds about as much as the kernel does (at 80 heads the two float32
    # results differ by ~1e-3 where the values reach 1e3)
    ts = [t.detach().double().requires_grad_(True) for t in ins]
    y, st = ssd_intra_chunk_ref(*ts)
    return torch.autograd.grad((y, st), ts, (dy.double(), dst.double()))


@pytest.mark.cuda
@pytest.mark.parametrize("big", [False, True], ids=["", "large-decay"])
@pytest.mark.parametrize("shape", SSD_BWD_SHAPES,
                         ids=[str(s) for s in SSD_BWD_SHAPES])
def test_cuda_ssd_bwd_kernel(cuda, shape, big):
    # against autograd of the plain version at the gradient bar; a chunk
    # whose |dA| sum passes 88 gives finite gradients; a second call is
    # bitwise the same
    bc, l, h, p, g, n = shape
    ins = _ssd_inputs(shape, cuda, da_scale=256.0 / l if big else 0.1,
                      seed=7)
    if big:
        assert float(ins[1][:, -1].abs().min()) > 88.0
    gen = torch.Generator(device=cuda).manual_seed(8)
    dy = torch.randn((bc, l, h, p), generator=gen, device=cuda)
    dst = torch.randn((bc, h, p, n), generator=gen, device=cuda)
    before = ssd_ops.bwd_launches
    got = ssd_ops.ssd_intra_chunk_bwd(*ins, dy, dst)
    again = ssd_ops.ssd_intra_chunk_bwd(*ins, dy, dst)
    torch.cuda.synchronize()
    assert ssd_ops.bwd_launches == before + 2
    want = _intra_grads_ref(ins, dy, dst)
    for a, b_, w in zip(got, again, want):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b_)
        torch.testing.assert_close(a.double(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 256, 24, 64, 128), (8, 32, 24, 64, 128),
                                   (3, 5, 2, 3, 5), (1, 1, 4, 8, 16)],
                         ids=["prefill", "train", "odd", "one-chunk"])
def test_cuda_chunk_recurrence_bwd_kernel(cuda, shape):
    bsz, nc, h, p, n = shape
    gen = torch.Generator(device=cuda).manual_seed(nc)
    states = torch.randn(shape, generator=gen, device=cuda)
    decay = torch.rand((bsz, nc, h), generator=gen, device=cuda) * 0.9 + 0.1
    init = torch.randn((bsz, h, p, n), generator=gen, device=cuda)
    ts = [t.clone().requires_grad_(True) for t in (states, decay, init)]
    prev, final = chunk_recurrence_ref(*ts)
    dprev = torch.randn(shape, generator=gen, device=cuda)
    dfin = torch.randn((bsz, h, p, n), generator=gen, device=cuda)
    want = torch.autograd.grad((prev, final), ts, (dprev, dfin))
    before = ssd_ops.state_bwd_launches
    got = ssd_ops.chunk_recurrence_bwd(dprev, dfin, prev.detach(), decay)
    again = ssd_ops.chunk_recurrence_bwd(dprev, dfin, prev.detach(), decay)
    torch.cuda.synchronize()
    assert ssd_ops.state_bwd_launches == before + 2
    for a, b_, w in zip(got, again, want):
        assert torch.equal(a, b_)
        torch.testing.assert_close(a, w, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.cuda
def test_cuda_lm_train_step_runs_the_ssd_backward_kernels(cuda):
    # a smoke mamba2 LM's loss and gradients on the card against the same
    # model on the CPU; remat: two forward launches a layer, one backward
    from repro_torch.configs import archs
    from repro_torch.models.transformer import LM
    from repro_torch.train import lm as lmtrain
    cfg = archs.smoke_config("mamba2-130m")
    gen = torch.Generator(device="cpu").manual_seed(0)
    ref = LM(cfg, device="cpu")
    ref.init(gen)
    model = LM(cfg, device=cuda)
    model.load_state_dict(ref.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
    batch = {"tokens": tokens, "labels": tokens}
    ssd_ops.reset_launches()
    loss, _, grads = lmtrain.loss_and_grads(
        model, {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    n = cfg.n_layers
    assert (ssd_ops.launches, ssd_ops.state_launches, ssd_ops.bwd_launches,
            ssd_ops.state_bwd_launches) == (2 * n, 2 * n, n, n)
    ref_loss, _, ref_grads = lmtrain.loss_and_grads(ref, batch)
    torch.testing.assert_close(loss.cpu(), ref_loss, rtol=1e-4, atol=1e-5)
    for k, g in grads.items():
        torch.testing.assert_close(g.cpu(), ref_grads[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, msg=k)


@pytest.mark.cuda
def test_cuda_ssd_chunked_and_lm_kernel_vs_reference(cuda):
    from repro_torch.configs import archs
    from repro_torch.kernels.config import KernelConfig
    from repro_torch.models import ssm as ssmlib
    from repro_torch.models.transformer import LM
    gen = torch.Generator(device=cuda).manual_seed(3)
    x, da, b, c = (torch.randn(s, generator=gen, device=cuda) for s in
                   ((2, 256, 8, 32), (2, 256, 8), (2, 256, 2, 16),
                    (2, 256, 2, 16)))
    da = -da.abs() * 0.5
    init = torch.randn((2, 8, 32, 16), generator=gen, device=cuda)
    before = ssd_ops.launches, ssd_ops.state_launches
    y, f = ssd_ops.ssd_chunked_kernel(x, da, b, c, 64, init)
    assert (ssd_ops.launches, ssd_ops.state_launches) == (before[0] + 1,
                                                          before[1] + 1)
    y_ref, f_ref = ssmlib.ssd_chunked(x, da, b, c, 64, init)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(f, f_ref, rtol=1e-4, atol=1e-4)

    cfg = archs.smoke_config("mamba2-130m")
    tokens = torch.randint(0, cfg.vocab_size, (2, 50), generator=gen,
                           device=cuda)
    logits = []
    for mode in ("kernel", "reference"):
        model = LM(cfg, device=cuda,
                   kernels=KernelConfig(ssd=mode))
        model.init(torch.Generator(device=cuda).manual_seed(4))
        before = ssd_ops.launches, ssd_ops.state_launches
        logits.append(model(tokens))
        want = cfg.n_layers if mode == "kernel" else 0
        assert (ssd_ops.launches - before[0],
                ssd_ops.state_launches - before[1]) == (want, want)
    torch.testing.assert_close(logits[0], logits[1], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_engine_staging_batching_and_bf16(cuda):
    # host aux goes through pinned memory and the engine's copy stream:
    # the same numbers as device-made aux, bitwise; two coalesced
    # requests hold the dispatch bar against their serial runs; the bf16
    # policy runs the kernels on widened operands
    import numpy as np
    from repro_torch.configs import fcn3 as cfgs
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.data import era5_synthetic as dlib
    from repro_torch.inference.engine import (EngineConfig, ForecastEngine,
                                              members_noise)
    from repro_torch.inference.params import load_params
    cfg = cfgs.fcn3_smoke()
    model = FCN3(cfg, device=cuda)
    ds = dlib.SyntheticERA5(cfg, device=cuda)
    bufs = model.make_buffers()
    s0s = [ds.state(s) for s in (1, 2)]
    load_params(model, ds, bufs, s0s[0], None, rounds=4)
    truths = [(lambda n, s=s: ds.state(s, n + 1)) for s in (1, 2)]
    host = np.stack([ds.aux_fields(6.0 * (n + 1)).cpu().numpy()
                     for n in range(3)])
    eng = ForecastEngine(model, EngineConfig(members=2, lead_chunk=2,
                                             spectra=True))
    a = eng.forecast(bufs, s0s[0], lambda n: host[n],
                     members_noise(model, 5), steps=3, truth=truths[0])
    b = eng.forecast(bufs, s0s[0], torch.from_numpy(host).to(cuda),
                     members_noise(model, 5), truth=truths[0])
    assert torch.equal(a.final_state, b.final_state)
    assert torch.equal(a.scores["spectrum"], b.scores["spectrum"])
    both = eng.forecast_batched(bufs, s0s, [lambda n: host[n]] * 2,
                                [members_noise(model, 5),
                                 members_noise(model, 6)],
                                steps=3, truths=truths)
    torch.testing.assert_close(both[0].final_state, a.final_state,
                               rtol=1e-4, atol=1e-5)
    for name in ("crps", "ssr", "spectrum"):
        torch.testing.assert_close(both[0].scores[name], a.scores[name],
                                   rtol=1e-4, atol=1e-6)
    before = legendre_ops.launches, disco_ops.launches
    half = ForecastEngine(model, EngineConfig(
        members=2, lead_chunk=3, compute_dtype="bfloat16")).forecast(
            bufs, s0s[0], host, members_noise(model, 5), truth=truths[0])
    assert legendre_ops.launches > before[0]
    assert disco_ops.launches > before[1]
    assert half.final_state.dtype == torch.bfloat16
    assert float((half.final_state.float() - a.final_state).abs().max()) \
        < 0.15
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
               for v in half.scores.values())


@pytest.mark.cuda
def test_cuda_engine_waits_for_device_data_in_flight(cuda):
    # device aux and truth arrays whose producing kernels are still
    # running on the compute stream: the copy stream reads them only after
    # those kernels, both when one chunk is staged on its own and through
    # a whole rollout, which equals one from the same arrays made
    # synchronously
    import numpy as np
    from repro_torch.configs import fcn3 as cfgs
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.data import era5_synthetic as dlib
    from repro_torch.inference.engine import (EngineConfig, ForecastEngine,
                                              members_noise)
    from repro_torch.inference.params import load_params
    cfg = cfgs.fcn3_smoke()
    model = FCN3(cfg, device=cuda)
    ds = dlib.SyntheticERA5(cfg, device=cuda)
    bufs = model.make_buffers()
    s0 = ds.state(1)
    load_params(model, ds, bufs, s0, None, rounds=1)
    aux = torch.from_numpy(np.stack([ds.aux_fields(6.0 * (n + 1)).cpu().numpy()
                                     for n in range(3)])).to(cuda)
    truth = torch.stack([ds.state(1, n + 1) for n in range(3)])
    torch.cuda.synchronize()
    eng = ForecastEngine(model, EngineConfig(members=2, lead_chunk=1))

    def late(x):
        # x again, written behind about a second of the compute stream
        out = torch.zeros_like(x)
        torch.cuda._sleep(2_000_000_000)
        return out.add_(x)

    # stage once first: the copy stream then has a block of this size
    # cached, and the staging below allocates without a cudaMalloc (which
    # may synchronize the device and hide a missing wait)
    eng._ready(eng._on_copy_stream(
        lambda: {"aux": eng._stage(aux, 0, 3, eng._mark())}))
    torch.cuda.synchronize()
    src = late(aux)
    mark = eng._mark()      # on the compute stream, as the stager takes it
    staged = eng._ready(eng._on_copy_stream(
        lambda: {"aux": eng._stage(src, 0, 3, mark)}))
    assert torch.equal(staged["aux"], aux)
    want = eng.forecast(bufs, s0, aux, members_noise(model, 5), truth=truth)
    got = eng.forecast(bufs, s0, late(aux), members_noise(model, 5),
                       truth=late(truth))
    assert torch.equal(got.final_state, want.final_state)
    for name, v in want.scores.items():
        assert torch.equal(got.scores[name], v), name


@pytest.mark.cuda
def test_cuda_scheduler_serves_through_the_kernels(cuda):
    # a smoke scheduler on the card: the request runs through the band
    # and Legendre kernels, its scores are fetched on the fetch thread's
    # stream, it equals a direct engine on the same model bitwise and the
    # port's reference (FFT/einsum) path at the dispatch bar; a second
    # request for the warm key reports no warm-up; the engine's
    # estimated_bytes covers what the requests add to the model's memory
    import threading

    import numpy as np
    from repro_torch.inference.engine import ForecastEngine, members_noise
    from repro_torch.serving.cache import ExecutableCache
    from repro_torch.serving.scheduler import ForecastScheduler, ModelPool
    from repro_torch.serving.spec import RequestSpec
    spec = RequestSpec(config="smoke", members=2, lead_steps=3, lead_chunk=2,
                       return_state=True)
    pool = ModelPool(device=cuda)
    sched = ForecastScheduler(pool=pool, cache=ExecutableCache())
    served = []

    def serve():
        t = threading.Thread(
            target=lambda: served.append(sched.submit(spec).result()),
            daemon=True)
        t.start()
        t.join(timeout=300)
        assert not t.is_alive()

    try:
        before = legendre_ops.launches, disco_ops.launches
        serve()
        # the first request also sets up state its streams keep (cuBLAS
        # workspaces, ~100 MB against a smoke step's few MB); the second
        # shows what a request on the warm key adds
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        serve()
        added = torch.cuda.max_memory_allocated() - base
        assert len(served) == 2
        assert legendre_ops.launches > before[0]
        assert disco_ops.launches > before[1]
        estimated = sum(e["estimated_bytes"]
                        for e in sched.stats()["engines"])
    finally:
        sched.close(timeout=60)
    assert 0 < added <= estimated, (added, estimated)
    b = pool.get("smoke")
    res, again = served
    assert again.timing["compile_s"] == 0.0 and again.cache["misses"] == 0

    def direct(kernels):
        eng = ForecastEngine(b.model, RequestSpec(
            **{**spec.to_dict(), "kernels": kernels}).engine_config())
        return eng.forecast(b.buffers, b.ds.state(spec.sample, 0),
                            lambda n: b.ds.aux_fields(6.0 * (n + 1)),
                            members_noise(b.model, spec.seed),
                            steps=spec.lead_steps,
                            truth=lambda n: b.ds.state(spec.sample, n + 1))

    same, ref = direct("auto"), direct("reference")
    np.testing.assert_array_equal(res.final_state,
                                  same.final_state.cpu().numpy())
    np.testing.assert_allclose(res.final_state, ref.final_state.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    for name, v in ref.scores.items():
        np.testing.assert_array_equal(res.scores[name],
                                      same.scores[name].cpu().numpy())
        atol = 1e-5 if name == "rank_hist" else 1e-6
        np.testing.assert_allclose(res.scores[name], v.cpu().numpy(),
                                   rtol=1e-4, atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# the distributed bodies with the kernels inside: a gloo world of 2 ranks
# on one card (NCCL refuses two ranks on one device)
# ---------------------------------------------------------------------------

def dist_kernels_rank(rank, world_size):
    """Rank body (spawned, so it lives at module level): Algorithm 1 on a
    (lat 1, lon 2) mesh, each rank's Legendre kernel on its order block,
    and Algorithm 2 on a (lat 2, lon 1) mesh, each rank's band kernel on
    its masked band; each against the single-process plain path."""
    from repro_torch.distributed import dist_disco, dist_sht
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import set_precision
    set_precision()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    lon = make_mesh((1, 2), ("lat", "lon"), "cuda")
    t = tsht.SHT.create(tgrids.make_grid(32, 64, "gauss"), lmax=32, mmax=32)
    m0, m1 = dist_sht.order_block(t.mmax, 2, rank)
    local = dist_sht.local_sht_buffers(t, m0, m1, dev)
    x = torch.randn((3, 8, 32, 64), generator=gen, device=dev)
    before = legendre_ops.launches
    c = dist_sht.dist_sht_forward(x[..., rank * 32:(rank + 1) * 32]
                                  .contiguous(), local, t.mmax,
                                  lon.get_group("lat"), lon.get_group("lon"))
    u = dist_sht.dist_sht_inverse(c, local, 64, lon.get_group("lat"),
                                  lon.get_group("lon"))
    out["legendre_launches"] = legendre_ops.launches - before
    bufs = t.buffers(dev)
    c_ref = tsht.sht_forward(x, bufs["wpct"])[..., m0:m1]
    u_ref = tsht.sht_inverse(tsht.sht_forward(x, bufs["wpct"]), bufs["pct"],
                             64)[..., rank * 32:(rank + 1) * 32]
    out["sht"] = max(_rel_err(c, c_ref), _rel_err(u, u_ref))
    lat = make_mesh((2, 1), ("lat", "lon"), "cuda")
    plan = _plan(PAIRS[0])
    h = plan.grid_in.nlat // 2
    xd = torch.randn((3, 4, 2 * h, plan.grid_in.nlon), generator=gen,
                     device=dev)
    before = disco_ops.launches
    got = dist_disco.dist_disco_conv(
        xd[:, :, rank * h:(rank + 1) * h].contiguous(),
        dist_disco.local_band_buffers(plan, rank, 2, dev), plan.stride,
        lat.get_group("lat"), lat.get_group("lon"))
    out["band_launches"] = disco_ops.launches - before
    ho = plan.grid_out.nlat // 2
    ref = tdisco.disco_conv(xd, torch.from_numpy(plan.psi).to(dev),
                            torch.from_numpy(plan.lat_idx).to(dev),
                            plan.stride)[..., rank * ho:(rank + 1) * ho, :]
    out["disco"] = _rel_err(got, ref)
    return out


@pytest.mark.cuda
def test_cuda_dist_bodies_run_their_kernels_in_a_gloo_world(cuda):
    from repro_torch.distributed.world import run_world
    from repro_torch.kernels import build
    build.build_all(("legendre", "disco_band"))
    res = run_world(dist_kernels_rank, 2, timeout=300.0)
    for r in res:
        assert r["legendre_launches"] > 0 and r["band_launches"] > 0, r
        assert r["sht"] <= REL_TOL and r["disco"] <= REL_TOL, r


# ---------------------------------------------------------------------------
# the domain-decomposed step: the band kernels on row-sliced bands, and a
# gloo world of 2 ranks on one card against the single process
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3], ids=["R2", "R3"])
@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_cuda_band_kernels_on_a_row_sliced_band(cuda, pair, n):
    from repro_torch.distributed import domain
    from repro_torch.distributed.compat import row_block
    tp = _plan(pair)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for r in range(n):
        lo, hi = row_block(tp.grid_out.nlat, r, n)
        need = domain.halo_rows(tp, lo, hi)
        tb = {k: torch.from_numpy(v).to(cuda) for k, v in
              domain.local_band_rows(tp, (lo, hi), need).items()}
        taps = disco_ops.LiveTaps.of(tb)
        x = torch.randn((11, len(need), pair[0][1]), generator=gen,
                        device=cuda)
        before = disco_ops.launches, disco_ops.transpose_launches
        got = disco_ops.disco_band_contract(x, tb["psi_band"], tb["lat_idx"],
                                            taps, tp.stride)
        ref = disco_gather_band_contract_ref(x, tb["psi_band"],
                                             tb["lat_idx"], tp.stride)
        assert _rel_err(got, ref) <= REL_TOL
        g = torch.randn(got.shape, generator=gen, device=cuda)
        gx = disco_ops.disco_band_transpose(
            g, tb["psi_band"], tb["lat_idx"], taps,
            disco_ops.RowTaps.of(tb), len(need), tp.stride)
        gref = disco_band_transpose_ref(g, tb["psi_band"], tb["lat_idx"],
                                        len(need), tp.stride)
        assert _rel_err(gx, gref) <= REL_TOL
        assert (disco_ops.launches, disco_ops.transpose_launches) == (
            before[0] + 1, before[1] + 1)


def domain_step_rank(rank, world_size):
    """Rank body: the domain-decomposed fcn3_smoke step's loss and reduced
    gradients on a (data 1, model 2) mesh over gloo, from seeded
    parameters and draws, with its kernel launches; rank 0 also takes the
    single process's step on the whole field."""
    from repro_torch.configs import fcn3 as tcfgs
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.data import era5_synthetic as tdata
    from repro_torch.inference.engine import GeneratorNoise
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import set_precision
    from repro_torch.train import trainer as ttr
    set_precision()
    dev = torch.device("cuda")
    cfg = tcfgs.fcn3_smoke()
    tcfg = ttr.TrainConfig(ensemble_size=2, rollout_steps=2, fair_crps=True)
    cw = tcfgs.channel_weights(cfg.n_levels)
    batch = next(iter(tdata.Loader(tdata.SyntheticERA5(cfg, device=dev),
                                   global_batch=1, rollout=2)))

    def model():
        m = FCN3(cfg, device=dev)
        m.init(torch.Generator(device=dev).manual_seed(0))
        return m

    def noise():
        return GeneratorNoise(torch.Generator(device=dev).manual_seed(5))

    mesh = make_mesh((1, world_size), ("data", "model"), "cuda")
    tr = ttr.EnsembleTrainer(model(), tcfg, cw, mesh=mesh)
    lo, hi = tr.domain.io_block
    bufs = dict(tr.domain.make_buffers(), **tr.make_loss_buffers())
    launches = (disco_ops.launches, disco_ops.transpose_launches,
                legendre_ops.launches, crps_ops.launches,
                crps_ops.bwd_launches)
    loss, _, grads = tr.loss_and_grads(
        bufs, {k: v[..., lo:hi, :] for k, v in batch.items()}, noise())
    out = {"loss": float(loss),
           "launches": [b - a for a, b in zip(launches, (
               disco_ops.launches, disco_ops.transpose_launches,
               legendre_ops.launches, crps_ops.launches,
               crps_ops.bwd_launches))],
           "grads": {k: g.cpu() for k, g in grads.items()}}
    if rank == 0:
        single = ttr.EnsembleTrainer(model(), tcfg, cw)
        m = single.model
        sl, _, sg = single.loss_and_grads(
            dict(m.make_buffers(), **single.make_loss_buffers()), batch,
            noise())
        out["single"] = (float(sl), {k: g.cpu() for k, g in sg.items()})
    return out


@pytest.mark.cuda
def test_cuda_domain_step_in_a_gloo_world(cuda):
    from repro_torch.distributed.world import run_world
    from repro_torch.kernels import build
    build.build_all(("legendre", "disco_band", "disco_band_bwd", "crps"))
    res = run_world(domain_step_rank, 2, timeout=300.0)
    sl, sg = res[0]["single"]
    for r in res:
        assert min(r["launches"]) > 0, r["launches"]
        assert abs(r["loss"] - sl) <= 1e-5 * abs(sl)
        for k, g in r["grads"].items():
            torch.testing.assert_close(g, sg[k], rtol=2e-3, atol=2e-4)


# ---------------------------------------------------------------------------
# the autotuner's tiles (kernels.autotune): every candidate the tune CLI
# sweeps by default builds and computes what the plain version computes

@pytest.fixture(scope="module")
def smoke_tune_shapes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.configs import fcn3 as cfgs
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.kernels import autotune
    shapes = autotune.model_op_shapes(FCN3(cfgs.fcn3_smoke(), device="cuda"),
                                      members=2)
    shapes["ssd"] = (8, 64, 12, 32, 1, 64)
    return shapes


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["legendre", "disco", "disco_bwd", "crps",
                                "ssd"])
def test_cuda_tile_candidates_match_plain(cuda, smoke_tune_shapes, op):
    from repro_torch.kernels import autotune, build
    shapes = smoke_tune_shapes[op]
    cands = autotune.candidates(op, shapes)       # the CLI's default cap
    build.build_all([autotune.library_for(op, d) for d in cands])
    runner = autotune.OpRunner(op, shapes, "cuda")
    ref = runner.plain()
    refs = ref if isinstance(ref, tuple) else (ref,)
    for dims in cands:
        got = runner(autotune.blocks_of(op, dims))()
        torch.cuda.synchronize()
        gots = got if isinstance(got, tuple) else (got,)
        for g, r in zip(gots, refs):
            assert _rel_err(g, r) <= REL_TOL, (op, dims)
        assert build.is_loaded(*autotune.library_for(op, dims))


@pytest.mark.cuda
def test_cuda_tuned_engine_matches_untuned(cuda):
    # an engine whose KernelConfig carries other tiles launches their
    # libraries and holds the dispatch bar against the committed ones
    from repro_torch.configs import fcn3 as cfgs
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.data import era5_synthetic as dlib
    from repro_torch.inference.engine import (EngineConfig, ForecastEngine,
                                              members_noise)
    from repro_torch.inference.params import load_params
    from repro_torch.kernels import build
    from repro_torch.kernels.config import BlockConfig, KernelConfig
    cfg = cfgs.fcn3_smoke()
    model = FCN3(cfg, device=cuda)
    ds = dlib.SyntheticERA5(cfg, device=cuda)
    bufs = model.make_buffers()
    s0 = ds.state(1)
    load_params(model, ds, bufs, s0, None, rounds=2)
    tuned = KernelConfig(blocks=(
        BlockConfig.make("legendre", TB=16, STAGES=3),
        BlockConfig.make("disco", CH=64, STAGES=4)))
    runs = {}
    for name, kc in (("committed", None), ("tuned", tuned)):
        eng = ForecastEngine(model, EngineConfig(members=2, lead_chunk=2,
                                                 kernels=kc))
        before = legendre_ops.launches, disco_ops.launches
        runs[name] = eng.forecast(bufs, s0,
                                  lambda n: ds.aux_fields(6.0 * (n + 1)),
                                  members_noise(model, 5), steps=3,
                                  truth=lambda n: ds.state(1, n + 1))
        assert legendre_ops.launches > before[0]
        assert disco_ops.launches > before[1]
        if kc is not None:
            libs = eng.kernel_libraries()
            assert libs == (("legendre", (("TUNE_STAGES", 3),
                                          ("TUNE_TB", 16))),
                            ("disco_band", (("TUNE_CH", 64),
                                            ("TUNE_STAGES", 4))))
            assert all(build.is_loaded(*lib) for lib in libs)
    a, b = runs["committed"], runs["tuned"]
    torch.testing.assert_close(b.final_state, a.final_state, rtol=1e-4,
                               atol=1e-5)
    for name, v in a.scores.items():
        torch.testing.assert_close(b.scores[name], v, rtol=1e-4,
                                   atol=1e-5 if name == "rank_hist"
                                   else 1e-6)


@pytest.mark.cuda
def test_cuda_dry_run_counts_the_launches_of_a_train_step(cuda):
    """The dry run on fake CUDA tensors (``launch/dryrun.py``) against a
    real ``fcn3_smoke`` train step on the card: each kernel family's
    calls equal its launches, and the dry run itself launches nothing."""
    from repro_torch.configs import fcn3 as tcfgs
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.inference.engine import GeneratorNoise
    from repro_torch.launch import counting, dryrun, roofline
    from repro_torch.train import trainer as ttr
    cfg = tcfgs.fcn3_smoke()

    def launches():
        return {"disco_band_contract": disco_ops.launches,
                "disco_band_transpose": disco_ops.transpose_launches,
                "legendre_contract": legendre_ops.launches,
                "crps_fused": crps_ops.launches,
                "crps_fused_bwd": crps_ops.bwd_launches}

    before = launches()
    with counting.DryRun() as dry:
        assert dry.device.type == "cuda"
        case = dryrun.build_fcn3_case("train", None, dry, cfg=cfg,
                                      sizes=(1, 2, 1))
        rl, counts = roofline.analyze("smoke", case.step, case.args, 1,
                                      case.model_flops, dry)
    assert launches() == before
    model = FCN3(cfg, device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    tr = ttr.EnsembleTrainer(model, ttr.TrainConfig(ensemble_size=2),
                             tcfgs.channel_weights(cfg.n_levels))
    bufs = dict(model.make_buffers(), **tr.make_loss_buffers())
    g = torch.Generator(device="cuda").manual_seed(1)
    hw = (cfg.nlat, cfg.nlon)
    batch = {"state": torch.randn((1, cfg.n_state) + hw, generator=g,
                                  device="cuda"),
             "targets": torch.randn((1, 1, cfg.n_state) + hw, generator=g,
                                    device="cuda"),
             "aux": torch.randn((1, 1, cfg.n_aux) + hw, generator=g,
                                device="cuda")}
    opt = tr.optimizer.init(dict(model.named_parameters()))
    before = launches()
    tr.train_step(bufs, opt, batch, GeneratorNoise(
        torch.Generator(device="cuda").manual_seed(2)))
    torch.cuda.synchronize()
    after = launches()
    assert {f: v["calls"] for f, v in counts.kernels.items()} == {
        k: after[k] - before[k] for k in after}
    assert rl.t_compute > 0 and rl.t_memory > 0 and counts.peak_bytes > 0
