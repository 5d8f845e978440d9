"""LM training: the loss, its gradients over the data ranks and one Adam
step, the counterpart of the JAX package's LM train step
(``jax.value_and_grad(model.loss, has_aux=True)`` then ``opt.update``).

The parameters are made to require grad (an ``LM`` is built without);
the gradient of every parameter is taken with ``torch.autograd.grad``,
zeros where the loss does not reach one, as JAX's.  On a mesh, the
batch is split over ``data_group``: the gradients are summed over its
ranks with one bucketed all-reduce and divided by their number, and the
loss and its terms are averaged the same way.  The update is
``optim/adam.py``'s, in place.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import compat
from repro_torch.optim import adam as adamlib


def loss_and_grads(model, batch: dict, data_group=None, moe_group=None
                   ) -> tuple[torch.Tensor, dict, dict[str, torch.Tensor]]:
    """``model.loss`` on ``batch`` (``tokens``, ``labels``, and
    ``patches`` / ``enc_frames`` where the family takes them), its terms
    and the gradient of every named parameter, averaged over
    ``data_group`` when there is one."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    loss, aux = model.loss(**batch, moe_group=moe_group)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params.values(), grads)]
    loss = loss.detach()
    aux = {k: v.detach() for k, v in aux.items()}
    if data_group is not None and compat.axis_size(data_group) > 1:
        n = compat.axis_size(data_group)
        compat.all_reduce_(grads, data_group)
        grads = [g / n for g in grads]
        diag = compat.psum(torch.stack([loss, *aux.values()]),
                           data_group) / n
        loss, aux = diag[0], dict(zip(aux, diag[1:]))
    return loss, aux, dict(zip(params, grads))


def train_step(model, opt: adamlib.Adam, opt_state: dict, batch: dict,
               data_group=None, moe_group=None) -> tuple[dict, dict]:
    """One optimizer step; the parameters are updated in place.  Returns
    the new optimizer state and {"loss", "ce", "lb_loss",
    "router_entropy", "grad_norm"} (the norm before any clipping)."""
    loss, aux, grads = loss_and_grads(model, batch, data_group, moe_group)
    opt_state = opt.update(dict(model.named_parameters()), grads, opt_state)
    return opt_state, {"loss": loss, **aux,
                       "grad_norm": adamlib.global_norm(grads)}
