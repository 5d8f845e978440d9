"""Adam (Kingma & Ba 2014; paper Table 3) over named parameter tensors.

Plain tensor functions, not ``torch.optim``, so the update is the JAX
package's formula term for term: global-norm clipping with a 1e-9 floor,
bias-corrected moments, eps outside the square root and decoupled
``weight_decay``.  The state keeps the JAX names: ``step`` (an int32
scalar), ``mu`` and ``nu`` (dicts keyed like the parameters).  The update
writes the new values into the parameters in place, where the JAX
version returns a new tree; the moments are replaced, not mutated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def global_norm(tensors: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in float32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors.values()))


def clip_by_global_norm(tensors: dict[str, torch.Tensor], max_norm: float,
                        norm: torch.Tensor | None = None
                        ) -> dict[str, torch.Tensor]:
    """Scale every tensor by min(1, max_norm / max(norm, 1e-9)); ``norm``
    is their global norm (computed here when None: a caller whose tensors
    are blocks of a parameter set spread over ranks passes the set's)."""
    if norm is None:
        norm = global_norm(tensors)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: t * scale.to(t.dtype) for k, t in tensors.items()}


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam with an optional schedule ``lr(step)`` and clipping."""

    lr: float | Schedule = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float | None = None

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        """Zero moments in float32 and step 0."""
        dev = next(iter(params.values())).device
        zeros = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": zeros,
                "nu": {k: torch.zeros_like(z) for k, z in zeros.items()}}

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        """The float32 learning rate at (1-based) ``step``."""
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor],
               grads: dict[str, torch.Tensor], state: dict,
               norm: torch.Tensor | None = None) -> dict:
        """One step: writes the new values into ``params``, returns the
        new state.  ``norm``: the gradients' global norm for the clipping
        (see ``clip_by_global_norm``)."""
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm, norm)
        step = state["step"] + 1
        b1, b2 = self.b1, self.b2
        mu = {k: b1 * m + (1 - b1) * grads[k].float()
              for k, m in state["mu"].items()}
        nu = {k: b2 * v + (1 - b2) * grads[k].float().square()
              for k, v in state["nu"].items()}
        sf = step.float()
        c1 = 1.0 - torch.pow(torch.tensor(b1, device=sf.device), sf)
        c2 = 1.0 - torch.pow(torch.tensor(b2, device=sf.device), sf)
        lr = self._lr(step)
        for k, p in params.items():
            pf = p.float()
            upd = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps)
            p.copy_((pf - lr * (upd + self.weight_decay * pf)).to(p.dtype))
        return {"step": step, "mu": mu, "nu": nu}


def constant_schedule(lr: float) -> Schedule:
    """The same rate at every step."""
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def halving_schedule(lr0: float, halve_every: int) -> Schedule:
    """Paper Table 3: halve the LR every ``halve_every`` steps."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        k = torch.div(step, halve_every, rounding_mode="floor").float()
        return lr0 * torch.pow(torch.tensor(0.5, device=step.device), k)
    return sched


def warmup_cosine_schedule(lr0: float, warmup: int, total: int,
                           floor: float = 0.0) -> Schedule:
    """Linear warm-up to ``lr0``, then a cosine decay to ``floor``."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = lr0 * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (lr0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * t))
        return torch.where(s < warmup, warm, cos)
    return sched
