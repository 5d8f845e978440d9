"""Kernel path of the SHT Legendre stage and the banded DISCO contraction.

Each kernel call sits in a ``torch.autograd.Function`` whose backward
runs the plain version (the counterpart of the JAX package's
``jax.custom_vjp`` pairs), so a model on the kernel path still has
gradients.  The wrappers themselves decide CPU (plain version) versus
CUDA (kernel launch) by where the tensors lie.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.sphere import disco as discolib
from repro_torch.core.sphere import fourier
from repro_torch.core.sphere import sht as shtlib
from repro_torch.kernels.disco import ops as disco_ops
from repro_torch.kernels.disco.ref import disco_gather_band_contract_ref
from repro_torch.kernels.legendre import ops as legendre_ops
from repro_torch.kernels.legendre.ref import legendre_contract_ref


def _plain_vjp(fn, inputs, grad):
    """Gradients of the plain version ``fn`` w.r.t. its float inputs."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(t.is_floating_point()
                                            or t.is_complex())
                  for t in inputs]
        out = fn(*leaves)
        wrt = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, grad, allow_unused=True))
    return tuple(next(grads) if t.requires_grad else None for t in leaves)


class _Legendre(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table):
        ctx.save_for_backward(x, table)
        return legendre_ops.legendre_contract(x, table)

    @staticmethod
    def backward(ctx, g):
        return _plain_vjp(legendre_contract_ref, ctx.saved_tensors, g)


class _BandContract(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, psi_band, lat_idx, stride):
        ctx.save_for_backward(x, psi_band, lat_idx)
        ctx.stride = stride
        return disco_ops.disco_band_contract(x, psi_band, lat_idx, stride)

    @staticmethod
    def backward(ctx, g):
        stride = ctx.stride
        grads = _plain_vjp(
            lambda x, p, i: disco_gather_band_contract_ref(x, p, i, stride),
            ctx.saved_tensors, g)
        return grads + (None,)


# ---------------------------------------------------------------------------
# SHT with the Legendre stage on the kernel
# ---------------------------------------------------------------------------

def _batched(c: torch.Tensor) -> torch.Tensor:
    """(..., K, M) complex64 as (B, K, M) with unit stride along m."""
    c = c.to(torch.complex64).reshape((-1,) + c.shape[-2:])
    return c if c.stride(-1) == 1 else c.contiguous()


def sht_forward(x: torch.Tensor, wpct: torch.Tensor) -> torch.Tensor:
    """Forward SHT, (..., H, W) -> (..., L, M) complex64.  Real and
    imaginary parts share one kernel launch, read in place."""
    h, l, m = wpct.shape
    w = x.shape[-1]
    xf = fourier.rfft(x.float())[..., :m] * (2.0 * math.pi / w)
    out = _Legendre.apply(_batched(xf), wpct)
    return out.reshape(xf.shape[:-2] + (l, m))


def sht_inverse(c: torch.Tensor, pct: torch.Tensor, nlon: int
                ) -> torch.Tensor:
    """Inverse SHT, (..., L, M) complex -> (..., H, nlon) real."""
    h, l, m = pct.shape
    # contract over degree: table (L, H, M), a transposed view of pct
    out = _Legendre.apply(_batched(c), pct.permute(1, 0, 2))
    spec = shtlib.pad_orders(out.reshape(c.shape[:-2] + (h, m)), nlon)
    return fourier.irfft(spec, nlon) * nlon


# ---------------------------------------------------------------------------
# Banded DISCO
# ---------------------------------------------------------------------------

def disco_conv_banded_buffers(x: torch.Tensor, buffers: dict, stride: int
                              ) -> torch.Tensor:
    """Banded-buffer DISCO contraction: band kernel + FFT wrap rows.

    x: (..., H_in, W_in) -> (..., K, H_out, W_out), matching
    ``core.sphere.disco.disco_conv`` on the full psi.  The kernel does
    the roll by ``off0 = -(D // 2)``, the latitude gather and the band
    contraction in one pass; the near-pole wrap rows (zero in the band)
    are recomputed by the exact FFT correlation and scattered back in.
    """
    psi_band, lat_idx = buffers["psi_band"], buffers["lat_idx"]
    k, h_out, s, d = psi_band.shape
    batch = x.shape[:-2]
    h_in, w_in = x.shape[-2:]
    xb = x.reshape((-1, h_in, w_in)).float().contiguous()
    out = _BandContract.apply(xb, psi_band, lat_idx, stride)
    wrap_rows = buffers["wrap_rows"]
    if wrap_rows.numel():
        rows = lat_idx.index_select(0, wrap_rows)          # (Hw, S)
        xw = discolib._gather_band(xb, rows)               # (B, Hw, S, W)
        outw = discolib.fft_correlate(xw, buffers["psi_wrap"], stride)
        out.index_copy_(2, wrap_rows, outw)
    return out.reshape(batch + (k, h_out, w_in // stride))
