"""Kernel path of the SHT Legendre stage, the banded DISCO contraction and
the chunked SSD scan.

Each kernel call sits in a ``torch.autograd.Function`` whose backward is
a kernel too, through the same wrappers: the Legendre contraction's
gradient in x is a Legendre contraction with the table transposed, and
the band contraction's is its transpose (``disco_band_transpose``).  Both
are linear in x, so neither saves x.  The tables, ``psi_band`` and the
index buffers (the tables' order extents, the band's live taps and
their lists by input row) are constants: neither backward returns a
gradient for them.  The wrappers themselves decide CPU (plain version) versus CUDA
(kernel launch) by where the tensors lie.  The SSD kernel has no
backward yet (ROADMAP A13): ``ssd_chunked`` serves the prefill only.
Each entry point takes the caller's ``KernelConfig`` and launches every
kernel at its ``blocks`` tile (the backwards too: each autograd function
keeps the tile of its forward).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.sphere import disco as discolib
from repro_torch.core.sphere import fourier
from repro_torch.core.sphere import sht as shtlib
from repro_torch.kernels.config import KernelConfig
from repro_torch.kernels.disco import ops as disco_ops
from repro_torch.kernels.legendre import ops as legendre_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import ssm as ssmlib


def _blocks(kernels: KernelConfig | None, op: str):
    return kernels.blocks_for(op) if kernels is not None else None


class _Legendre(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, extents, blocks=None):
        ctx.save_for_backward(table, extents)
        ctx.blocks = blocks
        return legendre_ops.legendre_contract(x, table, extents, blocks)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        table, extents = ctx.saved_tensors
        return legendre_ops.legendre_contract(
            g.contiguous(), table.transpose(0, 1),
            transposed_extents(extents), ctx.blocks), None, None, None


def transposed_extents(extents: torch.Tensor) -> torch.Tensor:
    """The extents of a table's (k, n) transpose: k and n swapped."""
    return extents.flip(0)


class _BandContract(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, psi_band, lat_idx, taps, rows, stride, kernels=None):
        ctx.save_for_backward(psi_band, lat_idx, *taps, *rows)
        ctx.stride, ctx.h_in = stride, x.shape[1]
        ctx.bwd_blocks = _blocks(kernels, "disco_bwd")
        return disco_ops.disco_band_contract(x, psi_band, lat_idx, taps,
                                             stride, _blocks(kernels, "disco"))

    @staticmethod
    def backward(ctx, g):
        gx = None
        if ctx.needs_input_grad[0]:
            psi_band, lat_idx, *lists = ctx.saved_tensors
            n = len(disco_ops.LiveTaps._fields)
            gx = disco_ops.disco_band_transpose(
                g.contiguous(), psi_band, lat_idx,
                disco_ops.LiveTaps(*lists[:n]), disco_ops.RowTaps(*lists[n:]),
                ctx.h_in, ctx.stride, ctx.bwd_blocks)
        return gx, None, None, None, None, None, None


# ---------------------------------------------------------------------------
# SHT with the Legendre stage on the kernel
# ---------------------------------------------------------------------------

def _batched(c: torch.Tensor) -> torch.Tensor:
    """(..., K, M) complex64 as (B, K, M) with unit stride along m."""
    c = c.to(torch.complex64).reshape((-1,) + c.shape[-2:])
    return c if c.stride(-1) == 1 else c.contiguous()


def legendre(c: torch.Tensor, table: torch.Tensor, extents: torch.Tensor,
             kernels: KernelConfig | None = None) -> torch.Tensor:
    """The Legendre step on the kernel, differentiable in ``c``:
    (..., K, M) complex -> (..., N, M) complex64 with table (K, N, M)
    float32 (a strided view will do) and its ``extents``.  Real and
    imaginary parts share one launch, read in place; the launches take
    ``kernels``' "legendre" tile."""
    n, m = table.shape[1:]
    out = _Legendre.apply(_batched(c), table, extents,
                          _blocks(kernels, "legendre"))
    return out.reshape(c.shape[:-2] + (n, m))


def sht_forward(x: torch.Tensor, wpct: torch.Tensor, wpct_ext: torch.Tensor,
                kernels: KernelConfig | None = None) -> torch.Tensor:
    """Forward SHT, (..., H, W) -> (..., L, M) complex64; ``wpct_ext`` is
    ``sht.order_extents(wpct)``.  The kernel takes fp32 operands: a bf16
    table (the bf16 policy) is widened here, as the reference's dispatch
    does."""
    w = x.shape[-1]
    xf = fourier.rfft(x.float())[..., :wpct.shape[2]] * (2.0 * math.pi / w)
    return legendre(xf, wpct.float(), wpct_ext, kernels)


def sht_inverse(c: torch.Tensor, pct: torch.Tensor, nlon: int,
                pct_ext: torch.Tensor, kernels: KernelConfig | None = None
                ) -> torch.Tensor:
    """Inverse SHT, (..., L, M) complex -> (..., H, nlon) real;
    ``pct_ext`` is ``sht.order_extents(pct)``; a bf16 table is widened to
    fp32 for the kernel."""
    # contract over degree: table (L, H, M), a transposed view of pct
    spec = legendre(c, pct.float().permute(1, 0, 2),
                    transposed_extents(pct_ext), kernels)
    return fourier.irfft(shtlib.pad_orders(spec, nlon), nlon) * nlon


# ---------------------------------------------------------------------------
# Banded DISCO
# ---------------------------------------------------------------------------

def disco_conv_banded_buffers(x: torch.Tensor, buffers: dict, stride: int,
                              kernels: KernelConfig | None = None
                              ) -> torch.Tensor:
    """Banded-buffer DISCO contraction: band kernel + FFT wrap rows.

    x: (..., H_in, W_in) -> (..., K, H_out, W_out), matching
    ``core.sphere.disco.disco_conv`` on the full psi.  The kernel does
    the roll by ``off0 = -(D // 2)``, the latitude gather and the band
    contraction in one pass over the band's live taps
    (``core.sphere.disco.band_live_taps``), its transpose over the same
    taps grouped by input row (``band_row_taps``); the near-pole wrap
    rows (zero in the band) are recomputed by the exact FFT correlation
    and scattered back in.  The band kernel and its transpose launch at
    ``kernels``' "disco" and "disco_bwd" tiles.
    """
    # the kernels take fp32 operands: under the bf16 policy psi and the
    # live taps' packed psi arrive bf16-rounded and are widened here, as
    # the reference's dispatch widens its band
    psi_band, lat_idx = buffers["psi_band"].float(), buffers["lat_idx"]
    taps = disco_ops.LiveTaps.of(buffers)
    k, h_out, s, d = psi_band.shape
    batch = x.shape[:-2]
    h_in, w_in = x.shape[-2:]
    xb = x.reshape((-1, h_in, w_in)).float().contiguous()
    out = _BandContract.apply(xb, psi_band, lat_idx,
                              taps._replace(psi=taps.psi.float()),
                              disco_ops.RowTaps.of(buffers), stride, kernels)
    wrap_rows = buffers["wrap_rows"]
    if wrap_rows.numel():
        rows = lat_idx.index_select(0, wrap_rows)          # (Hw, S)
        xw = discolib._gather_band(xb, rows)               # (B, Hw, S, W)
        outw = discolib.fft_correlate(xw, buffers["psi_wrap"], stride)
        out.index_copy_(2, wrap_rows, outw)
    return out.reshape(batch + (k, h_out, w_in // stride))


# ---------------------------------------------------------------------------
# Chunked SSD scan
# ---------------------------------------------------------------------------

def ssd_chunked(x: torch.Tensor, da: torch.Tensor, b_mat: torch.Tensor,
                c_mat: torch.Tensor, chunk: int, kernels: KernelConfig,
                initial_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan on the path ``kernels.ssd`` names: the
    intra-chunk kernel (``ssd_chunked_kernel``) or the plain einsum scan
    (``models.ssm.ssd_chunked``).  Same contract as both."""
    if kernels.ssd == "kernel":
        return ssd_ops.ssd_chunked_kernel(x, da, b_mat, c_mat, chunk,
                                          initial_state,
                                          kernels.blocks_for("ssd"))
    return ssmlib.ssd_chunked(x, da, b_mat, c_mat, chunk, initial_state)
