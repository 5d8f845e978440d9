"""Wrapper of the hand-written Legendre CUDA kernel (``csrc/legendre.cu``).

On a CPU tensor it computes the plain version (``ref.py``); on a CUDA
tensor it launches the kernel or raises.  The kernel reads and writes the
m-minor layout of the SHT as it is, so the wrapper copies nothing: a
complex ``x`` is read as interleaved floats, and a table may be a strided
view (the inverse SHT passes ``pct`` transposed).  The kernel contracts
each order only inside the extents it is given
(``core.sphere.sht.order_extents`` of the table, passed explicitly).
``blocks`` (a ``BlockConfig`` of family "legendre") picks the library of
another tile; the grid limits come from that library's own constants.
On fake tensors (a dry run) it launches nothing: it notes the call's
``work`` in ``kernels.tally`` and returns an empty fake output.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, tally
from repro_torch.kernels.config import BlockConfig, library_of
from repro_torch.kernels.legendre.ref import legendre_contract_ref

#: kernel launches since the last ``reset_launches`` (a plain integer).
launches = 0
#: what ``legendre_constants`` in ``csrc/legendre.cu`` exports, in order:
#: the tile (adjacent j, rows b, columns n, depth per slab, stages), the
#: threads of a block and its dynamic shared memory, real and complex
CONSTANTS = ("TJ", "TB", "TN", "TK", "STAGES", "THREADS", "SMEM_REAL",
             "SMEM_COMPLEX")


def reset_launches() -> None:
    """Set the launch count to 0."""
    global launches
    launches = 0


def _lib(blocks: BlockConfig | None):
    """The launcher of the library for ``blocks`` and its constants."""
    name, defines = library_of("legendre", blocks)
    fn = build.load_library(name, defines).legendre_contract_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, build.constants(name, defines, CONSTANTS)


def work(x_shape: tuple[int, int, int], n: int, complex_x: bool, nnz: int,
         n_extents: int) -> dict:
    """FLOPs and bytes of one call on x (B, K, M) and a (K, n, M) table
    with ``nnz`` non-zeros: the products the data needs (the tables are
    zero for m > l; a complex x counts its real and imaginary rows), the
    dense count beside them, and x, the table, the extents and the output
    once each."""
    b, k, m = x_shape
    parts = 2 if complex_x else 1
    return {"flops": 2.0 * parts * b * nnz,
            "flops_dense": 2.0 * parts * b * k * n * m,
            "bytes": 4.0 * (parts * b * k * m + k * n * m + parts * b * n * m
                            + n_extents)}


def _check(x: torch.Tensor, table: torch.Tensor, extents: torch.Tensor
           ) -> None:
    if x.dim() != 3 or table.dim() != 3:
        raise ValueError(f"legendre_contract wants x (B,K,M) and table "
                         f"(K,N,M), got {tuple(x.shape)} and "
                         f"{tuple(table.shape)}")
    b, k, m = x.shape
    k2, n, m2 = table.shape
    if (k, m) != (k2, m2):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} vs table "
                         f"{tuple(table.shape)}")
    if tuple(extents.shape) != (2, 2, m):
        raise ValueError(f"legendre_contract: extents must be (2, 2, {m}) "
                         f"(sht.order_extents), got {tuple(extents.shape)}")
    if x.dtype not in (torch.float32, torch.complex64):
        raise TypeError(f"legendre_contract: x must be float32 or "
                        f"complex64, got {x.dtype}")
    if table.dtype != torch.float32:
        raise TypeError(f"legendre_contract: table must be float32, got "
                        f"{table.dtype}")
    if extents.dtype != torch.int32 or not extents.is_contiguous():
        raise TypeError(f"legendre_contract: extents must be contiguous "
                        f"int32, got {extents.dtype}")
    for name, t in (("x", x), ("table", table), ("extents", extents)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"legendre_contract: {name} must be on "
                             f"{x.device}, got {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"legendre_contract: {name} must have unit "
                             f"stride along m, got strides {t.stride()}")


def _check_grid(x: torch.Tensor, n: int, tile: dict) -> None:
    """The launched tile's grid limits (its constants, from its library)."""
    b, k, m = x.shape
    j = m * (2 if x.is_complex() else 1)
    if (max(b, k, n, j) >= 2 ** 31 or -(-b // tile["TB"]) > 65535
            or -(-j // tile["TJ"]) > 65535):
        raise ValueError(f"legendre_contract: shape {(b, k, n, m)} exceeds "
                         f"the grid of the tile {tile}")


def legendre_contract(x: torch.Tensor, table: torch.Tensor,
                      extents: torch.Tensor,
                      blocks: BlockConfig | None = None) -> torch.Tensor:
    """out[b, n, m] = sum_k x[b, k, m] * table[k, n, m].

    x: (B, K, M) float32 or complex64; table: (K, N, M) float32; extents:
    (2, 2, M) int32, the table's ``sht.order_extents`` (rows k, columns
    n) -> (B, N, M) of x's dtype, contiguous.  The kernel contracts each
    block of orders inside the union of their extents and writes zeros
    outside it; the plain version reads the whole table.  A complex x
    contracts its real and imaginary parts with the same table in one
    launch.  ``blocks``: the tile to launch (None: the committed one);
    the plain version ignores it.
    """
    global launches
    if tally.is_fake(x, table, extents):
        return _counted(x, table, extents)
    if x.device.type == "cpu" and table.device.type == "cpu":
        return legendre_contract_ref(x, table)
    _check(x, table, extents)
    b, k, m = x.shape
    n = table.shape[1]
    fn, tile = _lib(blocks)
    _check_grid(x, n, tile)
    out = torch.empty((b, n, m), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    cshift = 1 if x.is_complex() else 0
    xf = torch.view_as_real(x) if cshift else x
    outf = torch.view_as_real(out) if cshift else out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(xf.data_ptr(), table.data_ptr(), extents.data_ptr(),
             outf.data_ptr(), b, k, n, m << cshift, cshift, xf.stride(0),
             xf.stride(1), table.stride(0), table.stride(1), stream)
    build.check_launch(err, "legendre_contract")
    launches += 1
    return out


def _counted(x: torch.Tensor, table: torch.Tensor, extents: torch.Tensor
             ) -> torch.Tensor:
    """The dry run's call: shapes checked, the work noted, nothing run."""
    if x.dim() != 3 or table.dim() != 3 or (x.shape[1], x.shape[2]) != (
            table.shape[0], table.shape[2]):
        raise ValueError(f"legendre_contract: x {tuple(x.shape)} and table "
                         f"{tuple(table.shape)} do not fit")
    n = table.shape[1]
    tally.note("legendre_contract", call_key(x, table),
               work(tuple(x.shape), n, x.is_complex(), tally.nnz(table),
                    extents.numel()))
    return x.new_empty((x.shape[0], n, x.shape[2]))


def call_key(x: torch.Tensor, table: torch.Tensor) -> tuple:
    """What tells one call's operands apart: x's shape and dtype, the
    table's shape and whether it is a transposed view (the inverse)."""
    return (tuple(x.shape), str(x.dtype).split(".")[-1], tuple(table.shape),
            table.is_contiguous())
