"""Mixture-of-experts configuration.

Only the ``MoEConfig`` dataclass is ported so far: ``configs/archs.py``
needs it to state its table.  ``init_moe`` and ``apply_moe`` come with
the MoE family (ROADMAP A13).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Routed experts per layer, as the JAX package's ``MoEConfig``.

    ``dispatch`` is "dense" (one-hot einsums) or "scatter" (capacity
    buffers over ``dp_axes``); ``shared_d_ff`` defaults to
    ``d_ff * n_shared``.
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
