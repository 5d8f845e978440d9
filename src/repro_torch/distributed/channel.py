"""Channel parallelism: FCN3's latent channels over the model axis (the
JAX package's ``sharding.fcn3_param_specs(mode="channel")``), and the
collectives it and the MoE expert placement share.

The JAX package gets this step from GSPMD partitioning ``core/fcn3.py``
with the channel specs; here, as ``distributed/domain.py`` does for the
latitude split, every op of the step is written for the rank's blocks.
The model's split parameters are this rank's blocks
(``sharding.place_parameters`` with the sanitized specs), so a leaf that
``sanitize_specs`` kept whole stays whole and its op stays local:

* a processor block's convolution, where its weight is split on C_out:
  the local DISCO conv (``weight`` (C_out/R, C_in, K)) contracts every
  input plane through the band kernel as on one process and merges only
  the rank's output channels; the global block's spectral filter
  (``w_re``/``w_im`` (C_out/R, C_in, L)) runs the forward SHT on every
  input channel and the inverse on the rank's output channels.  The
  output channels are gathered over the model ranks before the MLP,
  which contracts over all of them, and the bias is added once, after
  the gather;
* a block's ``MLP``, where ``w1``/``b1`` are split on the hidden dim
  and ``w2`` on its second: each rank's hidden channels give a partial
  product, summed over the model ranks; ``b2`` is added once, after the
  sum;
* everything else (the encoders, the decoders, LayerScale, the loss) is
  replicated: every model rank computes it whole, on the same values.

The collectives are autograd functions over ``compat``'s primitives
(``timed_kinds`` counts them): ``gather`` (the all-gather, whose
gradient is the rank's slice), ``compat.psum`` (the all-reduce, whose
gradient is the identity) and ``copy`` (the identity, whose gradient is
the all-reduce: it marks where a replicated value enters a split op,
whose input gradient is then a partial sum); ``shard`` (the rank's slice,
whose gradient is the all-gather) is ``gather``'s transpose, for the
expert placement.  With the backward's sums in these places, every
replicated leaf's gradient comes out whole and equal on every model
rank, and every split leaf's is its block's: the trainer averages both
over the data ranks only.

At ``fcn3_full`` the latent's 641 channels (a prime) split over no rank
count above 1: only the ten MLPs are split (30 leaves, 16,448,060 of
665,667,495 parameters), and a block costs one all-reduce of its MLP's
output forward (again in the checkpointed block's recomputation) and
one of its input gradient backward.
"""

from __future__ import annotations

import torch

from repro_torch.core import blocks as blk
from repro_torch.core.sphere import disco as discolib
from repro_torch.distributed import compat, sharding
from repro_torch.kernels.config import KernelConfig


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = compat.axis_size(group), compat.axis_index(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = group, dim
        return compat.all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, *ctx.args), None, None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = group, dim
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return compat.all_gather(g.contiguous(), *ctx.args), None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return compat._all_reduce(g, ctx.group), None


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's block concatenated along ``dim`` (the all-gather); its
    gradient is this rank's slice of the incoming one."""
    if compat.axis_size(group) == 1:
        return x
    return _Gather.apply(x, group, dim)


def shard(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` (equal blocks in rank order); its
    gradient is the all-gather of every rank's."""
    if compat.axis_size(group) == 1:
        return x
    return _Shard.apply(x, group, dim)


def copy(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient is the sum of every rank's (the
    all-reduce)."""
    if compat.axis_size(group) == 1:
        return x
    return _Copy.apply(x, group)


def split_norm(grads: dict[str, torch.Tensor], split: set[str], group
               ) -> torch.Tensor:
    """The global norm of a parameter set whose ``split`` leaves are
    spread over ``group`` in blocks (each rank holds its own) and whose
    other leaves are whole on every rank: the split leaves' squares
    summed over the group."""
    sq = [g.float().square().sum() for k, g in grads.items() if k in split]
    rest = [g.float().square().sum() for k, g in grads.items()
            if k not in split]
    total = (sum(rest) if rest else
             next(iter(grads.values())).new_zeros((), dtype=torch.float32))
    if sq:
        total = total + compat.psum(torch.stack(sq).sum(), group)
    return torch.sqrt(total)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def channel_specs(model, mesh) -> dict[str, tuple]:
    """The sanitized ``fcn3_param_specs(mode="channel")`` of ``model``'s
    whole parameters on ``mesh`` (a ``DeviceMesh`` or axis sizes)."""
    params = dict(model.named_parameters())
    return sharding.sanitize_specs(
        mesh, sharding.fcn3_param_specs(params, mode="channel"), params)


def _mlp(mlp: blk.MLP, x: torch.Tensor, group) -> torch.Tensor:
    """The block's MLP on its hidden block (``w1``/``b1`` rows, ``w2``
    columns): the partial product summed over ``group``, then ``b2``."""
    h = torch.einsum("oc,...chw->...ohw", mlp.w1.float(), copy(x, group))
    h = blk.gelu(h + mlp.b1[:, None, None])
    y = torch.einsum("oc,...chw->...ohw", mlp.w2.float(), h)
    return compat.psum(y, group) + mlp.b2[:, None, None]


def block_forward(block: blk.Block, x: torch.Tensor, cond: torch.Tensor,
                  buffers: dict, group,
                  kernels: KernelConfig | None = None) -> torch.Tensor:
    """``Block.forward`` with the block's parameters as placed: a split
    convolution on the rank's output channels, gathered, and a split MLP
    on its hidden channels, summed; a whole one as on one process."""
    c_lat = block.spec.c_latent
    cond = cond.expand(x.shape[:-3] + cond.shape[-3:])
    h = torch.cat([x, cond], dim=-3)
    conv = block.conv
    if block.spec.kind == "local":
        if conv.weight.shape[0] < c_lat:
            h = discolib.apply_disco_conv(conv.weight, None, copy(h, group),
                                          buffers, 1, conv.groups,
                                          kernels=kernels)
            h = gather(h, group, -3) + conv.bias.float()[:, None, None]
        else:
            h = conv(h, buffers, stride=1, kernels=kernels)
    else:
        split = conv.w_re.shape[0] < c_lat
        h = conv(copy(h, group) if split else h, buffers, nlon=x.shape[-1],
                 kernels=kernels)
        if split:
            h = gather(h, group, -3)
    h = blk.gelu(h)
    mlp = block.mlp
    h = (_mlp(mlp, h, group) if mlp.w1.shape[0] < block.spec.mlp_hidden
         else mlp(h))
    return x + block.layer_scale[:, None, None] * h


class ChannelFCN3:
    """``FCN3.forward`` with ``model``'s parameters placed over the model
    axis by ``specs`` (sanitized ``fcn3_param_specs(mode="channel")``):
    construction replaces the split parameters by this rank's blocks
    (``sharding.place_parameters``), so the model's own ``forward`` no
    longer applies.  ``group``: the model axis's group.  Every rank holds
    the whole fields; the output is the whole next state on every rank.
    """

    def __init__(self, model, mesh, specs: dict[str, tuple],
                 axis: str = sharding.MP):
        self.model, self.specs = model, specs
        self.group = compat.mesh_group(mesh, (axis,))
        #: every parameter's whole shape
        self.shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
        self.split = set(sharding.place_parameters(model, specs, mesh))

    def __call__(self, buffers: dict, state: torch.Tensor,
                 cond_in: torch.Tensor) -> torch.Tensor:
        """One step: state (..., n_state, H, W), cond_in (..., n_cond_in,
        H, W) -> u_{n+1}; with gradients on, each processor block is
        recomputed in backward, its collectives with it."""
        from torch.utils.checkpoint import checkpoint
        m, kc = self.model, self.model.cfg.kernels
        x, cond = m._encode(buffers, state, cond_in)
        remat = torch.is_grad_enabled() and (
            x.requires_grad
            or any(p.requires_grad for p in m.blocks.parameters()))
        for block in m.blocks:
            buf = (buffers["latent"] if block.spec.kind == "local"
                   else buffers["latent_sht"])
            if remat:
                x = checkpoint(block_forward, block, x, cond, buf,
                               self.group, kc, use_reentrant=False)
            else:
                x = block_forward(block, x, cond, buf, self.group, kc)
        del cond
        out = m._decode(buffers, x)
        return torch.where(m.water_mask, blk.softclamp(out), out)
