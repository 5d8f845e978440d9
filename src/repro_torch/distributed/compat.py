"""The collectives of the distributed bodies, with JAX's tiled semantics.

Each takes a ``ProcessGroup`` where JAX takes a mesh-axis name:

* ``axis_size`` / ``axis_index`` -- the group's size and this rank's
  index in it (``jax.lax.axis_size`` / ``axis_index``);
* ``all_to_all(x, group, split_dim, concat_dim)`` -- ``split_dim`` is cut
  into R blocks, block r goes to rank r, and the received blocks are
  concatenated along ``concat_dim`` in rank order (``jax.lax.all_to_all``
  with ``tiled=True``); its gradient is the all-to-all with the two dims
  swapped;
* ``psum_scatter(x, group, dim)`` -- the sum over ranks, block r of
  ``dim`` kept on rank r (tiled); built from the all-to-all and a local
  sum on every backend, so it differentiates through the all-to-all.
  gloo takes ``reduce_scatter_tensor`` on CUDA tensors too, but on one
  H100 (700 W) with two ranks it took 0.37 s where this took 0.23 s, on
  334 MB of Algorithm 2's partial sums (``chip_smoke.py``'s ``[dist]
  (b)`` probe);
* ``psum(x, group)`` -- the sum over ranks; its gradient is the identity,
  as JAX's when every rank backpropagates the same replicated value
  (multiplying it by R would count each rank's contribution R times);
* ``all_gather(x, group, dim)`` -- every rank's ``x`` concatenated along
  ``dim`` in rank order (``jax.lax.all_gather`` with ``tiled=True``); no
  gradient (``distributed/channel.py`` wraps it in autograd functions);
* ``all_to_all_v(x, group, dim, send_sizes, recv_sizes)`` -- the ragged
  all-to-all: ``dim`` of ``x`` is the blocks for each rank in rank order,
  of ``send_sizes`` rows each, and the result is the blocks received, in
  rank order, of ``recv_sizes`` rows; its gradient is the reverse
  exchange (the domain step's halo exchange rides on it);
* ``row_block(h, rank, n)`` -- the rows of ``h`` that rank ``rank`` of
  ``n`` holds, the loader's ragged split;
* ``mesh_group(mesh, axes)`` -- the group over several mesh axes
  together (a ``PartitionSpec`` entry naming a tuple of axes).

Complex tensors cross every collective as ``torch.view_as_real`` (gloo
and NCCL take no complex64).  Between ``start_timing()`` and
``timed_seconds()`` each collective is timed where it runs: on a CUDA
tensor by two CUDA events recorded on the current stream around it (no
synchronization of the card; ``timed_seconds`` waits for the last event),
on a CPU tensor by the host clock; ``timed_kinds()`` counts each kind's
output bytes on this rank (``all_to_all``, ``all_to_all_v``,
``all_reduce``, ``all_gather``, ``broadcast``; an all-to-all's and an
all-gather's output hold the rank's own block, ``all_to_all_v``'s only
what the peers sent), and ``timed_bytes()``
the bytes ``all_to_all_v`` received.  Outside such a window nothing is
recorded, except on fake tensors (a dry run): there every collective
notes its kind, group size and output bytes in ``kernels.tally``.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import tally

#: the timings since ``start_timing``: host seconds (CPU tensors) and
#: (start, end) CUDA event pairs; ``None`` while timing is off
_timed: list | None = None
#: the output bytes of each kind of collective since ``start_timing``
_kinds: dict[str, int] = {}
#: the kinds of collective, as ``timed_kinds`` and the dry run name them
KINDS = ("all_to_all", "all_to_all_v", "all_reduce", "all_gather",
         "broadcast")
#: ``mesh_group``'s groups over several axes, by world, mesh and axes
_mesh_groups: dict = {}


def start_timing() -> None:
    """Time every collective from here on (the earlier timings dropped)."""
    global _timed, _kinds
    _timed, _kinds = [], dict.fromkeys(KINDS, 0)


def timed_kinds() -> dict[str, int]:
    """The output bytes of each kind of collective on this rank since
    ``start_timing``."""
    return dict(_kinds)


def timed_bytes() -> int:
    """The bytes ``all_to_all_v`` received since ``start_timing``."""
    return _kinds.get("all_to_all_v", 0)


def timed_seconds() -> float:
    """The seconds spent in the collectives since ``start_timing``."""
    total = 0.0
    for t in _timed or ():
        if isinstance(t, float):
            total += t
        else:
            t[1].synchronize()
            total += t[0].elapsed_time(t[1]) / 1e3
    return total


def axis_size(group) -> int:
    """The number of ranks in ``group``."""
    return dist.get_world_size(group)


def axis_index(group) -> int:
    """This rank's index in ``group``."""
    return dist.get_rank(group)


def _run(kind: str, op, t: torch.Tensor, group, times: int = 1) -> None:
    """Run the collective ``op`` whose output on this rank is ``times``
    tensors like ``t``; count its bytes and time it while timing is on
    (see the module docstring), note it in ``kernels.tally`` on a fake
    tensor."""
    nbytes = times * t.numel() * t.element_size()
    if tally.is_fake(t):
        tally.note_collective(kind, dist.get_process_group_ranks(
            group or dist.group.WORLD), nbytes)
        op()
        return
    if _timed is None:
        op()
        return
    _kinds[kind] += nbytes
    if t.is_cuda:
        ev = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev[0].record()
        op()
        ev[1].record()
        _timed.append(ev)
    else:
        t0 = time.perf_counter()
        op()
        _timed.append(time.perf_counter() - t0)


def _all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int
                ) -> torch.Tensor:
    r = axis_size(group)
    nd = x.dim()
    split_dim, concat_dim = split_dim % nd, concat_dim % nd
    if r == 1:
        return x
    n = x.shape[split_dim]
    if n % r:
        raise ValueError(f"all_to_all: dim {split_dim} of size {n} does not "
                         f"split over {r} ranks")
    cplx = x.is_complex()
    xr = torch.view_as_real(x) if cplx else x
    # the split dim leads and is contiguous: block r is rows r*n/r.. of it
    send = xr.movedim(split_dim, 0).contiguous()
    recv = torch.empty_like(send)
    _run("all_to_all",
         lambda: dist.all_to_all_single(recv, send, group=group), recv,
         group)
    block = list(xr.shape)
    block[split_dim] = n // r
    # (R, n/R, rest): received blocks in rank order, each back in place
    out = recv.reshape((r, n // r) + send.shape[1:]).movedim(1, split_dim + 1)
    out = out.movedim(0, concat_dim)
    shape = block[:concat_dim] + [r * block[concat_dim]] + block[concat_dim
                                                                 + 1:]
    out = out.reshape(shape)
    return torch.view_as_complex(out.contiguous()) if cplx else out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g, ctx.group, concat_dim, split_dim), None, None,
                None)


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int
               ) -> torch.Tensor:
    """Tiled all-to-all over ``group`` (see the module docstring)."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def row_block(h: int, rank: int, n: int) -> tuple[int, int]:
    """The rows ``[lo, hi)`` of ``h`` that rank ``rank`` of ``n`` holds:
    ``((h * rank) // n, (h * (rank + 1)) // n)``, the JAX loader's split
    (ragged where ``n`` does not divide ``h``: 721 rows over 2 ranks are
    360 and 361)."""
    return (h * rank) // n, (h * (rank + 1)) // n


def _host_ranks(mesh) -> np.ndarray:
    """The mesh's global ranks as a host array, read with every dispatch
    mode off (under a dry run's fake mode the mesh's rank tensor would be
    made fake, and its values lost)."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return np.asarray(mesh.mesh.tolist())


def mesh_group(mesh, axes: tuple[str, ...]):
    """The process group over the mesh axes ``axes`` taken together,
    holding this rank: one axis is the mesh's own group; axes that cover
    the world are the default group; others are one new group per slice
    of the remaining axes, made on every rank in the same order (so the
    call is collective) and kept for later calls with the same world,
    mesh and axes.  A rank's index in it is its place in the sorted
    global ranks of its slice."""
    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    if len(dims) == 1:
        return mesh.get_group(axes[0])
    ids = _host_ranks(mesh)
    size = 1
    for d in dims:
        size *= ids.shape[d]
    if size == dist.get_world_size():
        return dist.group.WORLD
    key = (dist.group.WORLD, ids.shape, tuple(ids.flatten().tolist()),
           tuple(names), tuple(axes))
    if key not in _mesh_groups:
        rest = [d for d in range(ids.ndim) if d not in dims]
        me = dist.get_rank()
        for row in ids.transpose(rest + dims).reshape(-1, size).tolist():
            g = dist.new_group(row)
            if me in row:
                _mesh_groups[key] = g
    return _mesh_groups[key]


def _all_to_all_v(x: torch.Tensor, group, dim: int, send_sizes, recv_sizes
                  ) -> torch.Tensor:
    r = axis_size(group)
    dim = dim % x.dim()
    if len(send_sizes) != r or len(recv_sizes) != r:
        raise ValueError(f"all_to_all_v: {len(send_sizes)} send and "
                         f"{len(recv_sizes)} receive sizes for {r} ranks")
    if x.shape[dim] != sum(send_sizes):
        raise ValueError(f"all_to_all_v: dim {dim} of size {x.shape[dim]} "
                         f"is not the {sum(send_sizes)} rows sent")
    # the exchanged dim leads and is contiguous: each peer's block is a
    # run of rows
    send = x.movedim(dim, 0).contiguous()
    recv = send.new_empty((sum(recv_sizes),) + send.shape[1:])
    _run("all_to_all_v",
         lambda: dist.all_to_all_single(recv, send, list(recv_sizes),
                                        list(send_sizes), group=group),
         recv, group)
    return recv.movedim(0, dim)


class _AllToAllV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, send_sizes, recv_sizes):
        ctx.args = group, dim, send_sizes, recv_sizes
        return _all_to_all_v(x, group, dim, send_sizes, recv_sizes)

    @staticmethod
    def backward(ctx, g):
        group, dim, send_sizes, recv_sizes = ctx.args
        return (_all_to_all_v(g, group, dim, recv_sizes, send_sizes), None,
                None, None, None)


def all_to_all_v(x: torch.Tensor, group, dim: int, send_sizes, recv_sizes
                 ) -> torch.Tensor:
    """Ragged all-to-all over ``group`` along ``dim`` (see the module
    docstring); sizes are sequences of one int per rank.  Real tensors
    only."""
    return _AllToAllV.apply(x, group, dim, tuple(send_sizes),
                            tuple(recv_sizes))


def psum_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Tiled reduce-scatter over ``group``: block r of ``dim`` of the sum
    over ranks, on rank r."""
    dim = dim % x.dim()
    blocks = all_to_all(x.unsqueeze(0), group, dim + 1, 0)  # (R, ...)
    return blocks.sum(dim=0)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    if axis_size(group) > 1:
        buf = torch.view_as_real(out) if out.is_complex() else out
        _run("all_reduce", lambda: dist.all_reduce(buf, group=group), buf,
             group)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; the gradient passes through unchanged."""
    return _Psum.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (all of one shape) concatenated along ``dim`` in
    the group's rank order; complex tensors as their real views.  No
    autograd: see ``distributed/channel.py``."""
    r = axis_size(group)
    if r == 1:
        return x
    dim = dim % x.dim()
    cplx = x.is_complex()
    xr = (torch.view_as_real(x) if cplx else x).contiguous()
    parts = [torch.empty_like(xr) for _ in range(r)]
    # the list form: gloo gathers CUDA tensors in it
    _run("all_gather", lambda: dist.all_gather(parts, xr, group=group),
         xr, group, times=r)
    out = torch.cat(parts, dim=dim)
    return torch.view_as_complex(out.contiguous()) if cplx else out


def buckets(tensors: list[torch.Tensor], numel: int = 1 << 26):
    """``tensors`` in consecutive groups of at most ``numel`` elements
    (a larger tensor alone), each yielded with its flattened copy."""
    i = 0
    while i < len(tensors):
        j, n = i, 0
        while j < len(tensors) and (j == i or n + tensors[j].numel() <= numel):
            n += tensors[j].numel()
            j += 1
        yield tensors[i:j], torch.cat([t.reshape(-1) for t in tensors[i:j]])
        i = j


def all_reduce_(tensors: list[torch.Tensor], group) -> None:
    """Sum every tensor of ``tensors`` over ``group`` in place, a bucket
    at a time (no gradient: this is for gradients and statistics)."""
    if axis_size(group) == 1:
        return
    for part, flat in buckets(tensors):
        _run("all_reduce", lambda: dist.all_reduce(flat, group=group), flat,
             group)
        o = 0
        for t in part:
            t.copy_(flat[o:o + t.numel()].view_as(t))
            o += t.numel()


def broadcast_(tensors: list[torch.Tensor], src: int, group=None) -> None:
    """Overwrite every tensor with global rank ``src``'s, in place."""
    if dist.get_world_size(group) == 1:
        return
    for t in tensors:
        _run("broadcast", lambda t=t: dist.broadcast(t, src, group=group), t,
             group)
