"""Wrappers of the hand-written CRPS CUDA kernels (``csrc/crps.cu``) and
the autograd function that pairs them.

On CPU tensors each wrapper computes its plain version (``ref.py``); on
CUDA tensors it launches its kernel or raises.  ``crps_pointwise`` is the
counterpart of the JAX package's ``crps_pointwise_pallas``; the nodal
average of ``nodal_crps_pallas`` is ``core.crps.nodal_crps_loss``.
``blocks`` (a ``BlockConfig`` of family "crps") picks the library built
with another block size; both kernels of that library launch with it.
On fake tensors (a dry run) the wrappers launch nothing: they note their
``work`` in ``kernels.tally`` and return empty fake outputs.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, tally
from repro_torch.kernels.config import BlockConfig, library_of
from repro_torch.kernels.crps.ref import (crps_coeff, crps_fused_bwd_ref,
                                          crps_fused_ref)

#: forward / backward kernel launches since the last ``reset_launches``
launches = 0
bwd_launches = 0
#: the largest ensemble the kernels take (members live in registers);
#: must equal ``E_MAX`` in ``csrc/crps.cu``
MAX_MEMBERS = 16


def work(e: int, n: int, backward: bool = False) -> dict:
    """FLOPs and bytes of one call on an ensemble (E, N): per point the
    forward's 3E + 3E(E-1)/2 + 4 operations (the E(E-1)/2 pairs), E + 1
    floats in and 1 out; the backward's E(3E + 6), E + 2 in (g too) and E
    out."""
    if backward:
        return {"flops": float(e * (3 * e + 6)) * n,
                "bytes": 4.0 * n * (2 * e + 2)}
    return {"flops": float(3 * e + 3 * e * (e - 1) // 2 + 4) * n,
            "bytes": 4.0 * n * (e + 2)}


def reset_launches() -> None:
    """Set both launch counts to 0."""
    global launches, bwd_launches
    launches = bwd_launches = 0


def _lib(blocks: BlockConfig | None = None):
    lib = build.load_library(*library_of("crps", blocks))
    fwd, bwd = lib.crps_fwd_launch, lib.crps_bwd_launch
    fwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                             ctypes.c_float, ctypes.c_void_p])
    bwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                             ctypes.c_float, ctypes.c_void_p])
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(ens: torch.Tensor, obs: torch.Tensor,
           g: torch.Tensor | None = None) -> None:
    named = [("ens", ens), ("obs", obs)] + ([("g", g)] if g is not None
                                            else [])
    if ens.dim() != 2 or any(tuple(t.shape) != (ens.shape[1],)
                             for _, t in named[1:]):
        raise ValueError(f"crps_fused wants ens (E, N) and obs, g (N,), got "
                         f"{[tuple(t.shape) for _, t in named]}")
    e = ens.shape[0]
    if not 1 <= e <= MAX_MEMBERS:
        raise ValueError(f"crps_fused: the kernel holds at most MAX_MEMBERS="
                         f"{MAX_MEMBERS} members in registers, got E={e}")
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"crps_fused: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_cuda or t.device != ens.device:
            raise ValueError(f"crps_fused: {name} must be on {ens.device}, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"crps_fused: {name} must be contiguous")


def crps_fused(ens: torch.Tensor, obs: torch.Tensor, fair: bool = False,
               blocks: BlockConfig | None = None) -> torch.Tensor:
    """Pointwise ensemble CRPS: ens (E, N), obs (N,) -> (N,) float32;
    ``blocks``: the tile to launch (None: the committed one)."""
    global launches
    if tally.is_fake(ens, obs):
        e, n = ens.shape
        tally.note("crps_fused", ((e, n), fair), work(e, n))
        return ens.new_empty((n,), dtype=torch.float32)
    if ens.device.type == "cpu" and obs.device.type == "cpu":
        return crps_fused_ref(ens, obs, fair)
    _check(ens, obs)
    e, n = ens.shape
    out = torch.empty((n,), dtype=torch.float32, device=ens.device)
    if n == 0:
        return out
    fwd, _ = _lib(blocks)
    stream = torch.cuda.current_stream(ens.device).cuda_stream
    err = fwd(ens.data_ptr(), obs.data_ptr(), out.data_ptr(), e, n,
              crps_coeff(e, fair), stream)
    build.check_launch(err, "crps_fused")
    launches += 1
    return out


def crps_fused_bwd(g: torch.Tensor, ens: torch.Tensor, obs: torch.Tensor,
                   fair: bool = False, blocks: BlockConfig | None = None
                   ) -> torch.Tensor:
    """Gradient of ``sum(g * crps_fused(ens, obs))`` w.r.t. ens: (E, N)."""
    global bwd_launches
    if tally.is_fake(g, ens, obs):
        e, n = ens.shape
        tally.note("crps_fused_bwd", ((e, n), fair), work(e, n, True))
        return ens.new_empty((e, n), dtype=torch.float32)
    if all(t.device.type == "cpu" for t in (g, ens, obs)):
        return crps_fused_bwd_ref(g, ens, obs, fair)
    _check(ens, obs, g)
    e, n = ens.shape
    grad = torch.empty((e, n), dtype=torch.float32, device=ens.device)
    if n == 0:
        return grad
    _, bwd = _lib(blocks)
    stream = torch.cuda.current_stream(ens.device).cuda_stream
    err = bwd(g.data_ptr(), ens.data_ptr(), obs.data_ptr(), grad.data_ptr(),
              e, n, crps_coeff(e, fair), stream)
    build.check_launch(err, "crps_fused_bwd")
    bwd_launches += 1
    return grad


class _CRPS(torch.autograd.Function):
    """``crps_fused`` with ``crps_fused_bwd`` as its backward; the
    observations get no gradient (they are data)."""

    @staticmethod
    def forward(ctx, ens, obs, fair, blocks=None):
        ctx.save_for_backward(ens, obs)
        ctx.fair, ctx.blocks = fair, blocks
        return crps_fused(ens, obs, fair, blocks)

    @staticmethod
    def backward(ctx, g):
        ens, obs = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[0]:
            grad = crps_fused_bwd(g.contiguous(), ens, obs, ctx.fair,
                                  ctx.blocks)
        return grad, None, None, None


def crps_pointwise(ens: torch.Tensor, obs: torch.Tensor, fair: bool = False,
                   blocks: BlockConfig | None = None) -> torch.Tensor:
    """Drop-in for ``core.crps.crps_ensemble`` with the ensemble on dim 0.

    ens: (E, ...); obs: (...) -> (...) float32, through the kernels in
    both directions, at the tile ``blocks`` (None: the committed one).
    """
    e = ens.shape[0]
    flat = ens.float().reshape(e, -1).contiguous()
    out = _CRPS.apply(flat, obs.float().reshape(-1).contiguous(), fair,
                      blocks)
    return out.reshape(obs.shape)

