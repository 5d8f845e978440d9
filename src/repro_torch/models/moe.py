"""Mixture-of-experts FFN with capacity-based dispatch, as the JAX
package's ``models/moe.py``.

Top-k routing over ``n_experts`` with a per-expert capacity
C = ceil(tokens * k / E * capacity_factor); a (token, k) pair past its
expert's capacity is dropped.  Two dispatches compute the same layer:

* ``dense`` (``apply_moe``): the Switch-style (T, E, C) one-hot dispatch
  and combine tensors and einsums against them; positions within each
  expert by a cumulative sum in token-major order;
* ``scatter`` (``apply_moe_scatter``): over the data ranks of a
  ``torch.distributed`` group, each rank sorts its own pairs into its own
  capacity buffers (``cap_l = _capacity(T_local)``, a dump slot at
  ``cap_l``), runs the experts on them and combines locally; the aux
  losses are means over every rank's tokens (a sum over the group).

The expert placement (the JAX package's ``lm_param_specs``: the stacks'
experts over the model axis) is shared by both dispatches in
``_experts``: with the stacks placed (``LM.place_experts``), a rank
holds E/n experts of every stack and runs only their capacity buffers,
and the outputs are gathered over the model-axis group (``expert_group``)
into the whole (E, C, D) before the combine.  The collective follows
from where the tokens are: the reference replicates them over the model
axis (the batch is split over the data axes only), so every rank of the
group dispatches the same tokens into the same buffers, and what it
lacks is the other experts' outputs -- an all-gather over the group,
whose gradient is the rank's slice; the buffers' gradient is the
all-gather of every rank's experts' (``distributed.channel.shard``).  An
all-to-all would be the collective for tokens split over the same ranks
as the experts.  The expert products are plain einsums (the JAX package
computes them outside any Pallas kernel); no kernel of the port is
launched by this layer.

Supports shared (always-on) SwiGLU experts (deepseek-v2: 2 shared + 160
routed top-6; llama4-maverick: 1 shared + 128 routed top-1) and the
Switch load-balance loss.  ``observe`` hands each layer's ``Routing``
to a callback (drop counts, dispatch invariants) without changing the
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from collections.abc import Callable, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common as cm

Params = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Routed experts per layer, as the JAX package's ``MoEConfig``.

    ``dispatch`` is "dense" (one-hot einsums) or "scatter" (capacity
    buffers over the data ranks; ``dp_axes`` names the mesh axes, as in
    the JAX table); ``shared_d_ff`` defaults to ``d_ff * n_shared``.
    """

    d_model: int
    d_ff: int                  # per expert
    n_experts: int
    top_k: int
    n_shared: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    dispatch: str = "dense"
    dp_axes: tuple = ()

    @property
    def shared_width(self) -> int:
        """The shared SwiGLU's hidden width (0: no shared expert)."""
        if not self.n_shared:
            return 0
        return self.shared_d_ff or self.d_ff * self.n_shared


def moe_shapes(cfg: MoEConfig) -> dict[str, tuple[int, ...]]:
    """The router (D, E) and the stacked experts: ``w_gate`` and ``w_up``
    (E, D, F), ``w_down`` (E, F, D)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
            "w_down": (e, f, d)}


class MoE(cm.Params):
    """One MoE FFN's parameters (names as in the JAX tree: ``router``,
    ``w_gate``, ``w_up``, ``w_down`` and, with shared experts, the
    ``shared`` SwiGLU)."""

    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__(moe_shapes(cfg), device)
        self.cfg = cfg
        if cfg.n_shared:
            self.shared = cm.Params(
                cm.swiglu_shapes(cfg.d_model, cfg.shared_width), device)

    def params(self) -> dict:
        """The parameters by name, the shared SwiGLU's under ``shared``."""
        out = dict(self.named_parameters(recurse=False))
        if self.cfg.n_shared:
            out["shared"] = self.shared.params()
        return out


def _normal_(p: torch.Tensor, generator: torch.Generator, scale: float
             ) -> None:
    """Standard normal draws times ``scale``, written into ``p`` itself:
    at llama4's width one expert stack is 21.5 GB, and a temporary of that
    size beside the model's 74.7 GB does not fit on the card."""
    p.normal_(generator=generator).mul_(scale)


@torch.no_grad()
def init_moe(moe: MoE, generator: torch.Generator) -> None:
    """Draw ``moe``'s parameters in place, with the JAX package's
    distributions: the router and the shared SwiGLU as ``init_linear``
    (normal x 1/sqrt(d_in)), ``w_gate`` / ``w_up`` normal x 1/sqrt(D),
    ``w_down`` normal x 1/sqrt(F)."""
    cfg = moe.cfg
    s = 1.0 / math.sqrt(cfg.d_model)
    _normal_(moe.router, generator, s)
    _normal_(moe.w_gate, generator, s)
    _normal_(moe.w_up, generator, s)
    _normal_(moe.w_down, generator, 1.0 / math.sqrt(cfg.d_ff))
    if cfg.n_shared:
        for p in moe.shared.parameters():
            _normal_(p, generator, 1.0 / math.sqrt(p.shape[0]))


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert for ``tokens`` tokens: ceil(T k / E cf), at least
    one."""
    c = math.ceil(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(c, 1)


# ---------------------------------------------------------------------------
# Routing, and who sees it
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Routing:
    """One layer's routing of its T tokens: ``gate_idx`` (T, k) experts,
    ``pos`` (T, k) each pair's rank within its expert in token-major
    order, ``keep`` (T, k) pos < ``cap``; the dense path's ``dispatch``
    (T, E, C) or the scatter path's ``slot`` (T k,) (``cap`` for a
    dropped pair).  ``ranks``: the data ranks the layer ran over (1 for
    the dense path)."""

    gate_idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    cap: int
    n_experts: int
    dispatch: torch.Tensor | None = None
    slot: torch.Tensor | None = None
    ranks: int = 1


_observers: list[Callable[[Routing], None]] = []


@contextlib.contextmanager
def observe(fn: Callable[[Routing], None]):
    """Call ``fn(routing)`` for every MoE layer applied inside the block
    (in the order the layers run)."""
    _observers.append(fn)
    try:
        yield
    finally:
        _observers.remove(fn)


def _notify(routing: Routing) -> None:
    for fn in list(_observers):
        fn(routing)


def _route(params: Params, cfg: MoEConfig, xt: torch.Tensor):
    """Softmax over the fp32 router logits, its top k and the gates
    renormalised over them: probs (T, E), gate_vals (T, k), gate_idx
    (T, k)."""
    logits = cm.linear(params["router"], xt).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, gate_idx


def _experts(params: Params, xin: torch.Tensor, group=None
             ) -> torch.Tensor:
    """The SwiGLU experts on their buffers: (E, C, D) -> (E, C, D).  With
    the stacks placed over ``group`` (``params`` holding E/n experts, this
    rank's block in the group's rank order), the rank's experts run on
    their buffers and the outputs are gathered over the group."""
    placed = params["w_gate"].shape[0] < xin.shape[0]
    if placed:
        if group is None:
            raise ValueError(f"{params['w_gate'].shape[0]} of "
                             f"{xin.shape[0]} experts on this rank and no "
                             "expert group to gather the rest over")
        from repro_torch.distributed import channel
        xin = channel.shard(xin, group, 0)
    h = (F.silu(torch.einsum("ecd,edf->ecf", xin, params["w_gate"]))
         * torch.einsum("ecd,edf->ecf", xin, params["w_up"]))
    out = torch.einsum("ecf,efd->ecd", h, params["w_down"])
    if placed:
        out = channel.gather(out, group, 0)
    return out


def _aux(probs: torch.Tensor, gate_idx: torch.Tensor, cfg: MoEConfig,
         group=None) -> dict:
    """Switch load-balance loss E * sum_e f_e p_e / k and the router's
    mean entropy, both means over the tokens of every rank of ``group``
    (this rank's alone without one)."""
    e, k = cfg.n_experts, cfg.top_k
    onehot = F.one_hot(gate_idx, e).float()                  # (T, k, E)
    sums = torch.cat([onehot.sum(1).sum(0), probs.sum(0),
                      -(probs * torch.log(probs + 1e-9)).sum()[None]])
    n = probs.shape[0]
    if group is not None:
        from repro_torch.distributed import channel, compat
        # every rank's loss holds these aux and the step averages the
        # gradients over the group, so a rank's sums take the gradient of
        # every rank (JAX's psum transposes to a psum)
        sums = channel.copy(compat.psum(sums, group), group)
        n *= compat.axis_size(group)
    sums = sums / n
    frac_tokens, frac_probs, ent = sums[:e], sums[e:2 * e], sums[2 * e]
    lb = e * torch.sum(frac_tokens * frac_probs) / k
    return {"lb_loss": lb, "router_entropy": ent}


def zero_aux(device=None) -> dict:
    """The aux of a layer without experts: zeros."""
    return {"lb_loss": torch.zeros((), device=device),
            "router_entropy": torch.zeros((), device=device)}


# ---------------------------------------------------------------------------
# Dense dispatch
# ---------------------------------------------------------------------------

def scatter_group(cfg: MoEConfig, group, batch: int, seq_len: int):
    """The JAX package's choice of path, from the global shape: ``group``
    when the configuration asks for the scatter dispatch and the group
    has more than one rank and divides both the batch and the tokens
    (each rank then holds its own slice of the batch); else ``None``, the
    dense path (decode-shaped inputs: a batch smaller than the ranks,
    which every rank holds whole)."""
    if cfg.dispatch != "scatter" or group is None:
        return None
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if n > 1 and (batch * seq_len) % n == 0 and batch % n == 0:
        return group
    return None


def apply_moe(params: Params, cfg: MoEConfig, x: torch.Tensor, group=None,
              expert_group=None) -> tuple[torch.Tensor, dict]:
    """x (B, S, D) -> (B, S, D) and the aux {"lb_loss", "router_entropy"}.

    ``group``: the data ranks of which ``x`` is this rank's slice of the
    batch (``scatter_group``); with ``dispatch="scatter"`` the layer runs
    ``apply_moe_scatter`` over them.  Otherwise the dense dispatch over
    ``x``'s own tokens.  ``expert_group``: the ranks the experts are
    placed over, when ``params`` holds this rank's block of them.
    """
    if cfg.dispatch == "scatter" and group is not None:
        return apply_moe_scatter(params, cfg, x, group, expert_group)
    b, s, d = x.shape
    n_tok = b * s
    xt = x.reshape(n_tok, d)
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(n_tok, cfg)
    probs, gate_vals, gate_idx = _route(params, cfg, xt)

    # each pair's rank within its expert: the cumulative count over the
    # flattened (T k, E) one-hot, token-major, exact in int64
    onehot = F.one_hot(gate_idx, e)                          # (T, k, E)
    count = onehot.reshape(-1, e).cumsum(0).reshape(n_tok, k, e)
    pos = count.gather(-1, gate_idx[..., None])[..., 0] - 1  # (T, k)
    keep = pos < cap
    gates = gate_vals * keep

    # dispatch (T, E, C) and combine weights; a dropped pair has no slot
    onehot = onehot.float()
    pos_oh = (F.one_hot(torch.where(keep, pos, 0), cap).float()
              * keep[..., None])                             # (T, k, C)
    dispatch = torch.einsum("tke,tkc->tec", onehot, pos_oh)
    combine = torch.einsum("tke,tkc->tec", onehot * gates[..., None],
                           pos_oh)
    del pos_oh
    if _observers:
        _notify(Routing(gate_idx, pos, keep, cap, e, dispatch=dispatch))

    xin = torch.einsum("tec,td->ecd", dispatch, xt)          # (E, C, D)
    del dispatch
    xout = _experts(params, xin, expert_group)
    y = torch.einsum("tec,ecd->td", combine, xout).to(x.dtype)
    if "shared" in params:
        y = y + cm.swiglu(params["shared"], xt)
    return y.reshape(b, s, d), _aux(probs, gate_idx, cfg)


# ---------------------------------------------------------------------------
# Scatter dispatch over the data ranks
# ---------------------------------------------------------------------------

def _local_dispatch(xt: torch.Tensor, gate_idx: torch.Tensor, e: int,
                    cap: int):
    """Rank-local sort / scatter dispatch.  xt (T, D), gate_idx (T, k) ->
    buffers (E, cap, D), flat_e (T k,), slot (T k,), keep (T k,), pos
    (T k,).  The sort is stable, so pairs keep their token order within
    an expert, as the dense cumulative sum ranks them."""
    t, k = gate_idx.shape
    n = t * k
    dev = xt.device
    flat_e = gate_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    ar = torch.arange(n, device=dev)
    inv = torch.empty_like(order)
    inv[order] = ar
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    pos = (ar - starts[sorted_e])[inv]                     # rank in expert
    keep = pos < cap
    slot = torch.where(keep, pos, cap)                     # cap: dump slot
    xrep = xt.repeat_interleave(k, dim=0)                  # (T k, D)
    buf = xt.new_zeros((e, cap + 1, xt.shape[1]))
    buf.index_put_((flat_e, slot), xrep, accumulate=True)  # kept: unique
    return buf[:, :cap], flat_e, slot, keep, pos


def _local_combine(h: torch.Tensor, flat_e: torch.Tensor, slot: torch.Tensor,
                   weight: torch.Tensor, k: int) -> torch.Tensor:
    """h (E, cap, D) -> (T, D) through the rank-local dispatch's slots
    (the dump slot reads zeros)."""
    hpad = F.pad(h, (0, 0, 0, 1))
    y = hpad[flat_e, slot] * weight[:, None]
    return y.reshape(-1, k, h.shape[-1]).sum(dim=1)


def apply_moe_scatter(params: Params, cfg: MoEConfig, x: torch.Tensor,
                      group, expert_group=None
                      ) -> tuple[torch.Tensor, dict]:
    """The scatter dispatch over the data ranks of ``group``: ``x`` (B, S,
    D) is this rank's slice of the batch; each rank dispatches its own
    tokens into its own capacity buffers, runs the experts on them (its
    block of them, gathered over ``expert_group``, where they are placed)
    and combines locally.  The aux are means over every rank's tokens."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    e, k = cfg.n_experts, cfg.top_k
    probs, gate_vals, gate_idx = _route(params, cfg, xt)
    cap = _capacity(b * s, cfg)
    buf, flat_e, slot, keep, pos = _local_dispatch(xt, gate_idx, e, cap)
    if _observers:
        from repro_torch.distributed import compat
        _notify(Routing(gate_idx, pos.reshape(-1, k), keep.reshape(-1, k),
                        cap, e, slot=slot, ranks=compat.axis_size(group)))
    hout = _experts(params, buf, expert_group)
    del buf
    weight = gate_vals.reshape(-1) * keep
    y = _local_combine(hout.to(x.dtype), flat_e, slot, weight.to(x.dtype), k)
    if "shared" in params:
        y = y + cm.swiglu(params["shared"], xt)
    return y.reshape(b, s, d), _aux(probs, gate_idx, cfg, group)
