"""Wrappers of the hand-written banded DISCO CUDA kernels: the
contraction (``csrc/disco_band.cu``) and its transpose, the gradient in x
(``csrc/disco_band_bwd.cu``).

On CPU tensors each computes its plain version
(``ref.disco_gather_band_contract_ref``, ``ref.disco_band_transpose_ref``);
on CUDA tensors it launches its kernel or raises.  ``blocks`` (a
``BlockConfig`` of family "disco" or "disco_bwd") picks the library of
another tile; the grid and the shared memory a launch needs come from
that library's own exports (``*_constants``, ``*_smem_bytes``).  On
fake tensors (a dry run) each launches nothing: it notes its ``work`` /
``transpose_work`` in ``kernels.tally`` and returns an empty fake
output.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, tally
from repro_torch.kernels.config import BlockConfig, library_of
from repro_torch.kernels.disco.ref import (disco_band_transpose_ref,
                                           disco_gather_band_contract_ref)

#: contraction / transpose launches since the last ``reset_launches``
launches = 0
transpose_launches = 0
#: shared memory one block may use on the H100
_MAX_SMEM = 227 * 1024
#: what ``disco_band_constants`` (``csrc/disco_band.cu``) exports, in
#: order: output longitudes per block (8 warps x the mma's 16 rows),
#: planes per block, taps per staged piece of a slice, pipeline stages,
#: blocks an SM and threads a block
CONSTANTS = ("TW", "TBP", "CH", "STAGES", "MIN_BLOCKS", "THREADS")
#: what ``disco_band_bwd_constants`` (``csrc/disco_band_bwd.cu``)
#: exports: input longitudes and planes per block, taps per piece,
#: stages, blocks an SM, threads, and the Toeplitz offsets (less one)
#: of the generic path's blocks (a stride above 2: one residue class of
#: the input longitudes each)
TRANSPOSE_CONSTANTS = ("TV", "TBP", "CH", "STAGES", "MIN_BLOCKS", "THREADS",
                       "DM_ANY")


class LiveTaps(NamedTuple):
    """The band's live taps (``core.sphere.disco.band_live_taps``) on the
    device: ``ptr`` (H_out + 1,) and ``ent`` (E, 4) int32, ``psi`` (T, 8)
    float32, ``order`` (H_out,) int32."""

    ptr: torch.Tensor
    ent: torch.Tensor
    psi: torch.Tensor
    order: torch.Tensor

    @classmethod
    def of(cls, buffers: dict) -> "LiveTaps":
        """The live taps of ``DiscoPlan.banded_buffers``."""
        return cls(buffers["tap_ptr"], buffers["tap_ent"],
                   buffers["tap_psi"], buffers["row_order"])


class RowTaps(NamedTuple):
    """The live taps grouped by input row
    (``core.sphere.disco.band_row_taps``) on the device: ``ptr``
    (H_in + 1,), ``ent`` (E, 2) and ``order`` (H_in,) int32."""

    ptr: torch.Tensor
    ent: torch.Tensor
    order: torch.Tensor

    @classmethod
    def of(cls, buffers: dict) -> "RowTaps":
        """The per-input-row lists of ``DiscoPlan.banded_buffers``."""
        return cls(buffers["in_ptr"], buffers["in_ent"], buffers["in_order"])


def work(x_shape: tuple[int, int, int], psi_shape: tuple[int, ...],
         stride: int, nnz: int) -> dict:
    """FLOPs and bytes of one band contraction of x (B, H_in, W_in) with a
    band (K, H_out, S, D) of ``nnz`` non-zeros: the taps the filter really
    has at every output longitude, the dense band beside them, and x, the
    band, ``lat_idx`` and the output once each."""
    b, h_in, w_in = x_shape
    k, h_out, s, d = psi_shape
    w_out = w_in // stride
    return {"flops": 2.0 * nnz * w_out * b,
            "flops_dense": 2.0 * k * h_out * s * d * w_out * b,
            "bytes": 4.0 * (b * h_in * w_in + k * h_out * s * d + h_out * s
                            + b * k * h_out * w_out)}


def transpose_work(g_shape: tuple[int, int, int, int],
                   psi_shape: tuple[int, ...], h_in: int, stride: int,
                   nnz: int, list_numel: int) -> dict:
    """FLOPs and bytes of one transpose: the same taps as ``work``; g,
    the live taps and their lists by input row (``list_numel`` entries in
    all) in, gx (B, h_in, W_out * stride) out."""
    b, k, h_out, w_out = g_shape
    _, _, s, d = psi_shape
    return {"flops": 2.0 * nnz * w_out * b,
            "flops_dense": 2.0 * k * h_out * s * d * w_out * b,
            "bytes": 4.0 * (b * k * h_out * w_out + list_numel
                            + b * h_in * w_out * stride)}


def list_numel(taps: LiveTaps, rows: RowTaps) -> int:
    """The entries of the lists the transpose reads: the live taps'
    entries and packed psi, and every list by input row."""
    return (taps.ent.numel() + taps.psi.numel()
            + sum(t.numel() for t in rows))


def reset_launches() -> None:
    """Set both launch counts to 0."""
    global launches, transpose_launches
    launches = transpose_launches = 0


def _launcher(op: str, blocks: BlockConfig | None, entry: str,
              n_int: int, fields: tuple[str, ...]):
    """The launcher ``entry`` of the library of ``op`` at ``blocks``, its
    constants and its shared-memory function (bytes at a stride)."""
    name, defines = library_of(op, blocks)
    lib = build.load_library(name, defines)
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    smem = getattr(lib, f"{name}_smem_bytes")
    smem.argtypes = [ctypes.c_int]
    smem.restype = ctypes.c_longlong
    return fn, build.constants(name, defines, fields), smem


def _lib(blocks: BlockConfig | None = None):
    return _launcher("disco", blocks, "disco_band_launch", 8, CONSTANTS)


def _check_tensors(what: str, ref: torch.Tensor, named) -> None:
    for name, t, dt in named:
        if t.dtype != dt:
            raise TypeError(f"{what}: {name} must be {dt}, got {t.dtype}")
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f"{what}: {name} must be on {ref.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _check(x, psi_band, lat_idx, taps, stride, tile, smem) -> None:
    if x.dim() != 3 or psi_band.dim() != 4 or lat_idx.dim() != 2:
        raise ValueError(
            f"disco_band_contract wants x (B,H_in,W_in), psi_band "
            f"(K,H_out,S,D), lat_idx (H_out,S); got {tuple(x.shape)}, "
            f"{tuple(psi_band.shape)}, {tuple(lat_idx.shape)}")
    k, h_out, s, _ = psi_band.shape
    if tuple(lat_idx.shape) != (h_out, s):
        raise ValueError(f"lat_idx {tuple(lat_idx.shape)} does not match "
                         f"psi_band {tuple(psi_band.shape)}")
    if not 1 <= k <= 8:
        raise ValueError(f"disco_band_contract supports 1..8 basis "
                         f"functions, got {k}")
    if (tuple(taps.ptr.shape) != (h_out + 1,)
            or tuple(taps.order.shape) != (h_out,)
            or taps.ent.dim() != 2 or taps.ent.shape[1] != 4
            or taps.psi.dim() != 2 or taps.psi.shape[1] != 8
            or taps.psi.shape[0] % 8):
        raise ValueError(
            f"disco_band_contract: live taps ptr {tuple(taps.ptr.shape)}, "
            f"ent {tuple(taps.ent.shape)}, psi {tuple(taps.psi.shape)}, "
            f"order {tuple(taps.order.shape)} do not fit psi_band "
            f"{tuple(psi_band.shape)} (see band_live_taps)")
    if stride < 1 or x.shape[-1] % stride:
        raise ValueError(f"stride {stride} must divide W_in={x.shape[-1]}")
    if smem(stride) > _MAX_SMEM:
        raise ValueError(f"stride {stride} needs more shared memory than a "
                         f"block has at the tile {tile}")
    _check_tensors("disco_band_contract", x,
                   (("x", x, torch.float32),
                    ("psi_band", psi_band, torch.float32),
                    ("lat_idx", lat_idx, torch.int32),
                    ("taps.ptr", taps.ptr, torch.int32),
                    ("taps.ent", taps.ent, torch.int32),
                    ("taps.psi", taps.psi, torch.float32),
                    ("taps.order", taps.order, torch.int32)))
    blocks = (h_out * -(-x.shape[-1] // stride // tile["TW"])
              * -(-x.shape[0] // tile["TBP"]))
    if blocks >= 2 ** 31:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's grid")


def disco_band_contract(x: torch.Tensor, psi_band: torch.Tensor,
                        lat_idx: torch.Tensor, taps: LiveTaps,
                        stride: int = 1, blocks: BlockConfig | None = None
                        ) -> torch.Tensor:
    """Roll + latitude gather + banded contraction in one kernel.

    x: (B, H_in, W_in) float32; psi_band: (K, H_out, S, D) float32;
    lat_idx: (H_out, S) int32; ``taps``: psi_band's live taps
    (``band_live_taps``), which the kernel contracts instead of the
    dense band -> (B, K, H_out, W_in // stride) float32.  See
    ``ref.disco_gather_band_contract_ref`` for the exact function; the
    plain version reads psi_band and ignores ``taps`` and ``blocks`` (the
    tile to launch; None: the committed one).
    """
    global launches
    if tally.is_fake(x, psi_band, lat_idx):
        if x.dim() != 3 or psi_band.dim() != 4 or x.shape[-1] % stride:
            raise ValueError(f"disco_band_contract: x {tuple(x.shape)}, "
                             f"psi_band {tuple(psi_band.shape)}, stride "
                             f"{stride} do not fit")
        k, h_out = psi_band.shape[:2]
        tally.note("disco_band_contract",
                   (tuple(x.shape), tuple(psi_band.shape), stride),
                   work(tuple(x.shape), tuple(psi_band.shape), stride,
                        tally.nnz(psi_band)))
        return x.new_empty((x.shape[0], k, h_out, x.shape[-1] // stride),
                           dtype=torch.float32)
    if all(t.device.type == "cpu" for t in (x, psi_band, lat_idx)):
        return disco_gather_band_contract_ref(x, psi_band, lat_idx, stride)
    fn, tile, smem = _lib(blocks)
    _check(x, psi_band, lat_idx, taps, stride, tile, smem)
    b, h_in, w_in = x.shape
    k, h_out, s, d = psi_band.shape
    out = torch.empty((b, k, h_out, w_in // stride), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), lat_idx.data_ptr(), taps.ptr.data_ptr(),
             taps.ent.data_ptr(), taps.psi.data_ptr(), taps.order.data_ptr(),
             out.data_ptr(), b, h_in, w_in, k, h_out, s, d, stride, stream)
    build.check_launch(err, "disco_band_contract")
    launches += 1
    return out


def _bwd_lib(blocks: BlockConfig | None = None):
    return _launcher("disco_bwd", blocks, "disco_band_bwd_launch", 7,
                     TRANSPOSE_CONSTANTS)


def _check_transpose(g, psi_band, taps, rows, h_in, stride, tile,
                     smem) -> None:
    if g.dim() != 4 or psi_band.dim() != 4:
        raise ValueError(f"disco_band_transpose wants g (B,K,H_out,W_out) "
                         f"and psi_band (K,H_out,S,D), got {tuple(g.shape)}, "
                         f"{tuple(psi_band.shape)}")
    b, k, h_out, w_out = g.shape
    if psi_band.shape[:2] != (k, h_out):
        raise ValueError(f"disco_band_transpose: g {tuple(g.shape)} does not "
                         f"match psi_band {tuple(psi_band.shape)}")
    if not 1 <= k <= 8:
        raise ValueError(f"disco_band_transpose supports 1..8 basis "
                         f"functions, got {k}")
    if (tuple(taps.ptr.shape) != (h_out + 1,)
            or taps.ent.dim() != 2 or taps.ent.shape[1] != 4
            or taps.psi.dim() != 2 or taps.psi.shape[1] != 8
            or taps.psi.shape[0] % 8
            or tuple(rows.ptr.shape) != (h_in + 1,)
            or tuple(rows.order.shape) != (h_in,)
            or tuple(rows.ent.shape) != (taps.ent.shape[0], 2)):
        raise ValueError(
            f"disco_band_transpose: live taps ptr {tuple(taps.ptr.shape)}, "
            f"ent {tuple(taps.ent.shape)}, psi {tuple(taps.psi.shape)} and "
            f"row lists ptr {tuple(rows.ptr.shape)}, ent "
            f"{tuple(rows.ent.shape)}, order {tuple(rows.order.shape)} do "
            f"not fit psi_band {tuple(psi_band.shape)} and h_in={h_in} (see "
            f"band_live_taps, band_row_taps)")
    if stride < 1:
        raise ValueError(f"the transpose kernel takes a stride >= 1, got "
                         f"{stride}")
    if smem(stride) > _MAX_SMEM:
        raise ValueError(f"stride {stride} needs more shared memory than a "
                         f"block has at the tile {tile}")
    _check_tensors("disco_band_transpose", g,
                   (("g", g, torch.float32),
                    ("psi_band", psi_band, torch.float32),
                    ("taps.ent", taps.ent, torch.int32),
                    ("taps.psi", taps.psi, torch.float32),
                    ("rows.ptr", rows.ptr, torch.int32),
                    ("rows.ent", rows.ent, torch.int32),
                    ("rows.order", rows.order, torch.int32)))
    # plane tiles x input rows x longitude tiles (above stride 2, TV
    # longitudes of one residue class)
    tv = tile["TV"]
    tiles = (-(-w_out * stride // tv) if stride <= 2
             else stride * -(-w_out // tv))
    if -(-b // tile["TBP"]) * h_in * tiles >= 2 ** 31:
        raise ValueError(f"shape {tuple(g.shape)} exceeds the kernel's grid")


def disco_band_transpose(g: torch.Tensor, psi_band: torch.Tensor,
                         lat_idx: torch.Tensor, taps: LiveTaps,
                         rows: RowTaps, h_in: int, stride: int = 1,
                         blocks: BlockConfig | None = None) -> torch.Tensor:
    """Gradient of ``disco_band_contract`` in x, in one kernel.

    g: (B, K, H_out, W_out) float32 -> (B, h_in, W_out * stride) float32.
    ``taps``: psi_band's live taps (``band_live_taps``), ``rows``: the
    same slices grouped by input row (``band_row_taps``); the kernel
    reads those two and the shapes of psi_band, the plain version
    ``ref.disco_band_transpose_ref`` reads psi_band and ``lat_idx``.
    Deterministic: every output is written once.  ``blocks``: the tile
    (family "disco_bwd") to launch; None: the committed one.
    """
    global transpose_launches
    if tally.is_fake(g, psi_band, lat_idx):
        if g.dim() != 4 or psi_band.shape[:2] != g.shape[1:3]:
            raise ValueError(f"disco_band_transpose: g {tuple(g.shape)} does "
                             f"not fit psi_band {tuple(psi_band.shape)}")
        tally.note("disco_band_transpose",
                   (tuple(g.shape), tuple(psi_band.shape), h_in, stride),
                   transpose_work(tuple(g.shape), tuple(psi_band.shape),
                                  h_in, stride, tally.nnz(psi_band),
                                  list_numel(taps, rows)))
        return g.new_empty((g.shape[0], h_in, g.shape[-1] * stride),
                           dtype=torch.float32)
    if all(t.device.type == "cpu" for t in (g, psi_band, lat_idx)):
        return disco_band_transpose_ref(g, psi_band, lat_idx, h_in, stride)
    fn, tile, smem = _bwd_lib(blocks)
    _check_transpose(g, psi_band, taps, rows, h_in, stride, tile, smem)
    b, k, h_out, w_out = g.shape
    d = psi_band.shape[-1]
    gx = torch.empty((b, h_in, w_out * stride), dtype=torch.float32,
                     device=g.device)
    if gx.numel() == 0:
        return gx
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(g.data_ptr(), rows.ptr.data_ptr(), rows.ent.data_ptr(),
             rows.order.data_ptr(), taps.ent.data_ptr(), taps.psi.data_ptr(),
             gx.data_ptr(), b, k, h_out, w_out, h_in, d, stride, stream)
    build.check_launch(err, "disco_band_transpose")
    transpose_launches += 1
    return gx
