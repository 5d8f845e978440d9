"""Wrappers of the hand-written SSD CUDA kernels -- the intra-chunk step
(``csrc/ssd.cu``), the inter-chunk recurrence (``csrc/ssd_state.cu``)
and their backwards (``csrc/ssd_bwd.cu``, ``csrc/ssd_state_bwd.cu``) --
and the chunked scan around them.

``ssd_intra_chunk`` and ``chunk_recurrence`` compute their plain versions
(``ref.py``) on CPU tensors, which autograd differentiates, and launch
their kernels on CUDA tensors, or raise.  On CUDA each runs inside a
``torch.autograd.Function`` whose backward launches the backward kernel
(``ssd_intra_chunk_bwd``, ``chunk_recurrence_bwd``): the intra-chunk
step saves x, da_cs, B and C (its backward forms C B^T and the decay
again), the recurrence its decays and the entering states it returned.
``ssd_chunked_kernel`` is the counterpart of the JAX package's
``ssd_chunked_pallas``: the within-chunk cumsum and the incoming-state
term stay plain torch, as the JAX package left them to XLA, and the
recurrence over chunks (JAX's ``lax.scan``) is one kernel launch.
``blocks`` (a ``BlockConfig`` of family "ssd") picks the intra-chunk
library built with another tile; the other kernels keep their own.
On fake tensors (a dry run) nothing launches: each forward and backward
notes its ``work`` (``work``, ``state_work``, ``bwd_work``,
``state_bwd_work``) in ``kernels.tally`` and returns empty fake outputs.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, tally
from repro_torch.kernels.config import BlockConfig, library_of
from repro_torch.kernels.ssd.ref import (chunk_recurrence_bwd_ref,
                                         chunk_recurrence_ref,
                                         ssd_intra_chunk_bwd_ref,
                                         ssd_intra_chunk_ref)

#: intra-chunk, recurrence and their backward kernels' launches since the
#: last ``reset_launches`` (plain integers).
launches = 0
state_launches = 0
bwd_launches = 0
state_bwd_launches = 0
#: the largest chunk, head dim and state dim the kernel takes; must equal
#: ``L_MAX``, ``P_MAX`` and ``N_MAX`` in ``csrc/ssd.cu``
L_MAX, P_MAX, N_MAX = 128, 64, 128


def work(x_shape: tuple[int, int, int, int], g: int, n: int) -> dict:
    """FLOPs and bytes of one intra-chunk call on x (BC, L, H, P) with
    B and C (BC, L, G, N): the work the data needs (C B^T once per group
    on the causal s <= l taps, att @ X on those taps and the state product,
    per head), the dense count beside it, and x, da_cs, B, C in and y and
    the states out."""
    bc, l, h, p = x_shape
    taps = l * (l + 1) // 2
    return {"flops": 2.0 * bc * (g * taps * n + h * taps * p + h * l * p * n),
            "flops_dense": 2.0 * bc * h * (l * l * n + l * l * p + l * p * n),
            "bytes": 4.0 * (2 * bc * l * h * p + bc * l * h + 2 * bc * l * g * n
                            + bc * h * p * n)}


def state_work(states_shape: tuple[int, int, int, int, int]) -> dict:
    """FLOPs and bytes of one recurrence over states (B, nc, H, P, N): a
    multiply-add per entry; the states, the decays and the incoming state
    in, the entering states and the final state out."""
    bsz, nc, h, p, n = states_shape
    numel = bsz * nc * h * p * n
    return {"flops": 2.0 * numel,
            "bytes": 4.0 * (2 * numel + bsz * nc * h + 2 * bsz * h * p * n)}


def bwd_work(x_shape: tuple[int, int, int, int], g: int, n: int) -> dict:
    """FLOPs and bytes of one intra-chunk backward on x (BC, L, H, P) with
    B and C (BC, L, G, N): the work the data needs -- per head att^T dy
    and dy X^T on the causal s <= l taps, B dst^T and (w X) dst whole;
    per group C B^T formed again, dCB B and dCB^T C on the causal taps --
    and x, da_cs, B, C, dy, dst in and dx, dda_cs, dB, dC out."""
    bc, l, h, p = x_shape
    taps = l * (l + 1) // 2
    return {"flops": 2.0 * bc * (h * (2 * taps * p + 2 * l * p * n)
                                 + g * 3 * taps * n),
            "bytes": 4.0 * (3 * bc * l * h * p + 2 * bc * l * h
                            + 4 * bc * l * g * n + bc * h * p * n)}


def state_bwd_work(states_shape: tuple[int, int, int, int, int]) -> dict:
    """FLOPs and bytes of one recurrence backward over states (B, nc, H,
    P, N): a multiply-add and a product-sum per entry; dprev, prev and
    the decays in, dstates out, dfinal in and dinit out."""
    bsz, nc, h, p, n = states_shape
    numel = bsz * nc * h * p * n
    return {"flops": 4.0 * numel,
            "bytes": 4.0 * (3 * numel + 2 * bsz * nc * h
                            + 2 * bsz * h * p * n)}


def reset_launches() -> None:
    """Set every launch count to 0."""
    global launches, state_launches, bwd_launches, state_bwd_launches
    launches = state_launches = bwd_launches = state_bwd_launches = 0


def _lib(blocks: BlockConfig | None = None):
    fn = build.load_library(*library_of("ssd", blocks)).ssd_intra_chunk_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x, da_cs, b_mat, c_mat) -> None:
    """Shapes, dtype and groups: refused on any device."""
    named = (("x", x), ("da_cs", da_cs), ("b_mat", b_mat), ("c_mat", c_mat))
    if x.dim() != 4 or da_cs.dim() != 3 or b_mat.dim() != 4:
        raise ValueError(f"ssd_intra_chunk wants x (BC,L,H,P), da_cs "
                         f"(BC,L,H), b_mat and c_mat (BC,L,G,N), got "
                         f"{[tuple(t.shape) for _, t in named]}")
    bc, l, h, _ = x.shape
    g, n = b_mat.shape[2:]
    if (tuple(da_cs.shape) != (bc, l, h)
            or tuple(b_mat.shape) != (bc, l, g, n)
            or tuple(c_mat.shape) != (bc, l, g, n)):
        raise ValueError(f"ssd_intra_chunk: shape mismatch "
                         f"{[tuple(t.shape) for _, t in named]}")
    if g < 1 or h % g:
        raise ValueError(f"ssd_intra_chunk: H={h} heads must split evenly "
                         f"into G={g} groups")
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_intra_chunk: {name} must be float32, got "
                            f"{t.dtype}")


def _check_device(what: str, named) -> None:
    """One card, contiguity: what every kernel needs."""
    ref = named[0][1]
    for name, t in named:
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f"{what}: {name} must be on {ref.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _check_cuda(x, da_cs, b_mat, c_mat) -> None:
    """What the kernel itself needs: one card, contiguity, sizes."""
    _check_device("ssd_intra_chunk", (("x", x), ("da_cs", da_cs),
                                      ("b_mat", b_mat), ("c_mat", c_mat)))
    _, l, h, p = x.shape
    n = b_mat.shape[3]
    if not (l <= L_MAX and p <= P_MAX and n <= N_MAX):
        raise ValueError(f"ssd_intra_chunk: the kernel takes L <= {L_MAX}, "
                         f"P <= {P_MAX}, N <= {N_MAX}; got L={l}, P={p}, "
                         f"N={n}")
    if x.shape[0] * h >= 2 ** 31:
        raise ValueError(f"ssd_intra_chunk: BC * H = {x.shape[0] * h} "
                         "exceeds the kernel's grid")


def _state_lib():
    fn = build.load_library("ssd_state").ssd_state_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    lib = build.load_library("ssd_bwd")
    fn = lib.ssd_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    scratch = lib.ssd_bwd_scratch
    scratch.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 2
    scratch.restype = ctypes.c_longlong
    return fn, scratch


def _state_bwd_lib():
    lib = build.load_library("ssd_state_bwd")
    fn = lib.ssd_state_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    parts = lib.ssd_state_bwd_parts
    parts.argtypes = [ctypes.c_int] * 2
    parts.restype = ctypes.c_int
    return fn, parts


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _intra_launch(x, da_cs, b_mat, c_mat, blocks):
    """The forward kernel (or, on fake tensors, its note)."""
    global launches
    bc, l, h, p = x.shape
    g, n = b_mat.shape[2:]
    if tally.is_fake(x, da_cs, b_mat, c_mat):
        tally.note("ssd_intra_chunk", (tuple(x.shape), tuple(b_mat.shape)),
                   work(tuple(x.shape), g, n))
        return x.new_empty(x.shape), x.new_empty((bc, h, p, n))
    _check_cuda(x, da_cs, b_mat, c_mat)
    y = torch.empty((bc, l, h, p), dtype=torch.float32, device=x.device)
    st = torch.empty((bc, h, p, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0 or st.numel() == 0:
        return y.zero_(), st.zero_()
    err = _lib(blocks)(x.data_ptr(), da_cs.data_ptr(), b_mat.data_ptr(),
                       c_mat.data_ptr(), y.data_ptr(), st.data_ptr(), bc, l,
                       h, p, g, n, _stream(x))
    build.check_launch(err, "ssd_intra_chunk")
    launches += 1
    return y, st


def ssd_intra_chunk_bwd(x: torch.Tensor, da_cs: torch.Tensor,
                        b_mat: torch.Tensor, c_mat: torch.Tensor,
                        dy: torch.Tensor, dstates: torch.Tensor
                        ) -> tuple[torch.Tensor, ...]:
    """Gradients of ``ssd_intra_chunk`` in x, da_cs, b_mat and c_mat, given
    those of its outputs: dy (BC, L, H, P) and dstates (BC, H, P, N).  One
    call of ``csrc/ssd_bwd.cu`` on CUDA tensors (two launches: the heads,
    then the groups; one count); autograd of the plain version on CPU
    tensors.  Its scratch holds a partial of dCB and of dB's state part
    per (chunk, group, tile of heads), the size the library reports."""
    global bwd_launches
    _check(x, da_cs, b_mat, c_mat)
    bc, l, h, p = x.shape
    g, n = b_mat.shape[2:]
    if tuple(dy.shape) != (bc, l, h, p) or tuple(dstates.shape) != (
            bc, h, p, n):
        raise ValueError(f"ssd_intra_chunk_bwd: dy {tuple(dy.shape)} and "
                         f"dstates {tuple(dstates.shape)} do not match x "
                         f"{tuple(x.shape)}, N={n}")
    if tally.is_fake(x, da_cs, b_mat, c_mat, dy, dstates):
        tally.note("ssd_intra_chunk_bwd",
                   (tuple(x.shape), tuple(b_mat.shape)),
                   bwd_work(tuple(x.shape), g, n))
        return (x.new_empty(x.shape), x.new_empty(da_cs.shape),
                x.new_empty(b_mat.shape), x.new_empty(c_mat.shape))
    named = (("x", x), ("da_cs", da_cs), ("b_mat", b_mat), ("c_mat", c_mat),
             ("dy", dy), ("dstates", dstates))
    if all(t.device.type == "cpu" for _, t in named):
        return ssd_intra_chunk_bwd_ref(x, da_cs, b_mat, c_mat, dy, dstates)
    for name, t in named[4:]:
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_intra_chunk_bwd: {name} must be float32, "
                            f"got {t.dtype}")
    _check_cuda(x, da_cs, b_mat, c_mat)
    _check_device("ssd_intra_chunk_bwd", named)
    outs = [torch.empty_like(t) for t in (x, da_cs, b_mat, c_mat)]
    if x.numel() == 0:
        return tuple(o.zero_() for o in outs)
    fn, scratch = _bwd_lib()
    part = torch.empty((scratch(bc, h, g),), dtype=torch.float32,
                       device=x.device)
    err = fn(x.data_ptr(), da_cs.data_ptr(), b_mat.data_ptr(),
             c_mat.data_ptr(), dy.data_ptr(), dstates.data_ptr(),
             *(o.data_ptr() for o in outs), part.data_ptr(), bc, l, h, p, g,
             n, _stream(x))
    build.check_launch(err, "ssd_intra_chunk_bwd")
    bwd_launches += 1
    return tuple(outs)


class _IntraChunk(torch.autograd.Function):
    """The intra-chunk kernel with the backward kernel as its gradient;
    saves the inputs, not att."""

    @staticmethod
    def forward(ctx, x, da_cs, b_mat, c_mat, blocks):
        ctx.save_for_backward(x, da_cs, b_mat, c_mat)
        return _intra_launch(x, da_cs, b_mat, c_mat, blocks)

    @staticmethod
    def backward(ctx, dy, dstates):
        x, da_cs, b_mat, c_mat = ctx.saved_tensors
        bc, l, h, p = x.shape
        n = b_mat.shape[3]
        dy = (x.new_zeros((bc, l, h, p)) if dy is None
              else dy.float().contiguous())
        dstates = (x.new_zeros((bc, h, p, n)) if dstates is None
                   else dstates.float().contiguous())
        return (*ssd_intra_chunk_bwd(x, da_cs, b_mat, c_mat, dy, dstates),
                None)


def ssd_intra_chunk(x: torch.Tensor, da_cs: torch.Tensor, b_mat: torch.Tensor,
                    c_mat: torch.Tensor, blocks: BlockConfig | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused intra-chunk SSD, the counterpart of the JAX package's
    ``ssd_intra_chunk``.

    x: (BC, L, H, P) dt-scaled inputs; da_cs: (BC, L, H) inclusive cumsum
    of dt*A within each chunk; b_mat, c_mat: (BC, L, G, N), shared by the
    H/G heads of a group; all float32.  Returns (y_diag (BC, L, H, P),
    states (BC, H, P, N)), differentiable in all four inputs.
    ``blocks``: the tile to launch (None: the committed one); the plain
    version ignores it.
    """
    _check(x, da_cs, b_mat, c_mat)
    if not tally.is_fake(x, da_cs, b_mat, c_mat) and all(
            t.device.type == "cpu" for t in (x, da_cs, b_mat, c_mat)):
        return ssd_intra_chunk_ref(x, da_cs, b_mat, c_mat)
    return _IntraChunk.apply(x, da_cs, b_mat, c_mat, blocks)


def _check_recurrence(states, chunk_decay, init) -> None:
    if states.dim() != 5:
        raise ValueError(f"chunk_recurrence wants states (B,nc,H,P,N), got "
                         f"{tuple(states.shape)}")
    bsz, nc, h, p, n = states.shape
    if (tuple(chunk_decay.shape) != (bsz, nc, h)
            or tuple(init.shape) != (bsz, h, p, n)):
        raise ValueError(f"chunk_recurrence: shape mismatch states "
                         f"{tuple(states.shape)}, chunk_decay "
                         f"{tuple(chunk_decay.shape)}, init "
                         f"{tuple(init.shape)}")
    for name, t in (("states", states), ("chunk_decay", chunk_decay),
                    ("init", init)):
        if t.dtype != torch.float32:
            raise TypeError(f"chunk_recurrence: {name} must be float32, got "
                            f"{t.dtype}")


def _state_launch(states, chunk_decay, init):
    """The recurrence kernel (or, on fake tensors, its note)."""
    global state_launches
    if tally.is_fake(states, chunk_decay, init):
        tally.note("ssd_chunk_recurrence", (tuple(states.shape),),
                   state_work(tuple(states.shape)))
        return states.new_empty(states.shape), init.new_empty(init.shape)
    _check_device("chunk_recurrence", (("states", states),
                                       ("chunk_decay", chunk_decay),
                                       ("init", init)))
    bsz, nc, h, p, n = states.shape
    prev = torch.empty_like(states)
    final = torch.empty_like(init)
    if nc == 0 or init.numel() == 0:
        return prev, final.copy_(init)
    err = _state_lib()(states.data_ptr(), chunk_decay.data_ptr(),
                       init.data_ptr(), prev.data_ptr(), final.data_ptr(),
                       bsz, nc, h, p, n, _stream(states))
    build.check_launch(err, "chunk_recurrence")
    state_launches += 1
    return prev, final


def chunk_recurrence_bwd(dprev: torch.Tensor, dfinal: torch.Tensor,
                         prev: torch.Tensor, chunk_decay: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``chunk_recurrence`` in its states, chunk_decay and
    init, given those of its outputs (dprev (B, nc, H, P, N), dfinal (B,
    H, P, N)) and the entering states ``prev`` it returned.  One launch
    of ``csrc/ssd_state_bwd.cu`` on CUDA tensors; the plain reverse scan
    on CPU tensors.  Returns (dstates, dchunk_decay, dinit)."""
    global state_bwd_launches
    _check_recurrence(prev, chunk_decay, dfinal)
    if tuple(dprev.shape) != tuple(prev.shape):
        raise ValueError(f"chunk_recurrence_bwd: dprev {tuple(dprev.shape)} "
                         f"against prev {tuple(prev.shape)}")
    if tally.is_fake(dprev, dfinal, prev, chunk_decay):
        tally.note("ssd_chunk_recurrence_bwd", (tuple(prev.shape),),
                   state_bwd_work(tuple(prev.shape)))
        return (prev.new_empty(prev.shape),
                chunk_decay.new_empty(chunk_decay.shape),
                dfinal.new_empty(dfinal.shape))
    named = (("dprev", dprev), ("dfinal", dfinal), ("prev", prev),
             ("chunk_decay", chunk_decay))
    if all(t.device.type == "cpu" for _, t in named):
        return chunk_recurrence_bwd_ref(dprev, dfinal, prev, chunk_decay)
    if dprev.dtype != torch.float32:
        raise TypeError(f"chunk_recurrence_bwd: dprev must be float32, got "
                        f"{dprev.dtype}")
    _check_device("chunk_recurrence_bwd", named)
    bsz, nc, h, p, n = prev.shape
    dstates = torch.empty_like(prev)
    ddecay = torch.empty_like(chunk_decay)
    dinit = torch.empty_like(dfinal)
    if nc == 0 or dfinal.numel() == 0:
        return dstates, ddecay.zero_(), dinit.copy_(dfinal)
    fn, parts = _state_bwd_lib()
    part = torch.empty((bsz * nc * h * parts(p, n),), dtype=torch.float32,
                       device=prev.device)
    err = fn(dprev.data_ptr(), dfinal.data_ptr(), prev.data_ptr(),
             chunk_decay.data_ptr(), dstates.data_ptr(), dinit.data_ptr(),
             ddecay.data_ptr(), part.data_ptr(), bsz, nc, h, p, n,
             _stream(prev))
    build.check_launch(err, "chunk_recurrence_bwd")
    state_bwd_launches += 1
    return dstates, ddecay, dinit


class _Recurrence(torch.autograd.Function):
    """The recurrence kernel with the backward kernel as its gradient;
    saves the decays and the entering states it returns."""

    @staticmethod
    def forward(ctx, states, chunk_decay, init):
        prev, final = _state_launch(states, chunk_decay, init)
        ctx.save_for_backward(prev, chunk_decay)
        return prev, final

    @staticmethod
    def backward(ctx, dprev, dfinal):
        prev, chunk_decay = ctx.saved_tensors
        bsz, _, h, p, n = prev.shape
        dprev = (torch.zeros_like(prev) if dprev is None
                 else dprev.float().contiguous())
        dfinal = (prev.new_zeros((bsz, h, p, n)) if dfinal is None
                  else dfinal.float().contiguous())
        return chunk_recurrence_bwd(dprev, dfinal, prev, chunk_decay)


def chunk_recurrence(states: torch.Tensor, chunk_decay: torch.Tensor,
                     init: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The inter-chunk scan: one kernel launch on CUDA tensors, the plain
    loop (``ref.chunk_recurrence_ref``) on CPU tensors; differentiable in
    all three inputs.

    states: (B, nc, H, P, N) each chunk's own end state; chunk_decay:
    (B, nc, H) exp of each chunk's dA sum; init: (B, H, P, N); float32.
    Returns (the state entering each chunk (B, nc, H, P, N), the final
    state (B, H, P, N)).
    """
    _check_recurrence(states, chunk_decay, init)
    if not tally.is_fake(states, chunk_decay, init) and all(
            t.device.type == "cpu" for t in (states, chunk_decay, init)):
        return chunk_recurrence_ref(states, chunk_decay, init)
    return _Recurrence.apply(states, chunk_decay, init)


def ssd_chunked_kernel(x: torch.Tensor, da: torch.Tensor, b_mat: torch.Tensor,
                       c_mat: torch.Tensor, chunk: int,
                       initial_state: torch.Tensor | None = None,
                       blocks: BlockConfig | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan with the intra-chunk step on the kernel at the tile
    ``blocks``; the same contract as ``repro_torch.models.ssm.ssd_chunked``.

    x: (B, S, H, P) dt-scaled; da: (B, S, H); b_mat, c_mat: (B, S, G, N);
    S a multiple of ``chunk``.  Returns (y (B, S, H, P) float32,
    final_state (B, H, P, N) float32).
    """
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2:]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    rep = h // g

    def to_chunks(t, tail):
        return t.float().reshape((bsz * nc, chunk) + tail).contiguous()

    xc = to_chunks(x, (h, p))
    bc = to_chunks(b_mat, (g, n))
    cc = to_chunks(c_mat, (g, n))
    da_cs = torch.cumsum(to_chunks(da, (h,)), dim=1)

    y_diag, states = ssd_intra_chunk(xc, da_cs, bc, cc, blocks)
    states = states.reshape(bsz, nc, h, p, n)
    da_cs = da_cs.reshape(bsz, nc, chunk, h)

    init = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
            if initial_state is None else initial_state.float().contiguous())
    prev, final = chunk_recurrence(
        states, torch.exp(da_cs[:, :, -1, :]).contiguous(), init)

    # y_off[l, h, p] = exp(cs[l, h]) * sum_n C[l, g(h), n] prev[h, p, n]:
    # one batched product per group, the H/G heads of a group side by side
    cg = cc.reshape(bsz * nc, chunk, g, n).transpose(1, 2)        # (BC,G,L,N)
    pg = prev.reshape(bsz * nc, g, rep * p, n).transpose(2, 3)    # (BC,G,N,rP)
    y_off = torch.matmul(cg, pg).transpose(1, 2)                  # (BC,L,G,rP)
    y_off = y_off.reshape(bsz, nc, chunk, h, p) * torch.exp(da_cs)[..., None]
    y = y_diag.reshape(bsz, nc, chunk, h, p) + y_off
    return y.reshape(bsz, s, h, p), final
