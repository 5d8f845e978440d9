"""Forecast-model parameters: calibrated init, or weights carried over
from and to the JAX package.

``params_from_numpy`` takes the JAX parameter tree flattened to numpy
arrays keyed by tree path (``enc_atmos/weight``, ``blocks/3/mlp/w1``,
...) and returns the port's ``state_dict`` names; ``params_to_numpy``
goes the other way, and ``opt_state_to_numpy`` / ``opt_state_from_numpy``
do the same for an Adam state (``step``, ``mu/<path>``, ``nu/<path>``).
``load_arrays_npz`` reads the reference checkpoint format (``arrays.npz``
with keys prefixed ``params/``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

_PREFIX = "params/"


def params_from_numpy(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """JAX tree-path keys -> the port's ``state_dict`` keys (``/`` -> ``.``)."""
    return {key.replace("/", "."): torch.from_numpy(np.array(val))
            for key, val in flat.items()}


def params_to_numpy(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's names -> JAX tree-path keys (``.`` -> ``/``), on the host."""
    return {key.replace(".", "/"): val.detach().cpu().numpy()
            for key, val in params.items()}


def opt_state_to_numpy(state: dict) -> dict[str, np.ndarray]:
    """An Adam state as the JAX package flattens it: ``step`` (int32
    scalar), ``mu/<path>`` and ``nu/<path>``."""
    flat = {"step": state["step"].detach().cpu().numpy().astype(np.int32)}
    for part in ("mu", "nu"):
        flat.update({f"{part}/{k}": v for k, v in
                     params_to_numpy(state[part]).items()})
    return flat


def opt_state_from_numpy(flat: dict[str, np.ndarray],
                         device: str | torch.device = "cpu") -> dict:
    """The inverse of ``opt_state_to_numpy``, on ``device``."""
    def part(name: str) -> dict[str, torch.Tensor]:
        sub = {k[len(name) + 1:]: v for k, v in flat.items()
               if k.startswith(name + "/")}
        return {k: v.to(device) for k, v in params_from_numpy(sub).items()}

    step = torch.as_tensor(np.asarray(flat["step"]), dtype=torch.int32)
    return {"step": step.to(device), "mu": part("mu"), "nu": part("nu")}


def load_arrays_npz(path: str) -> dict[str, np.ndarray]:
    """The ``params/...`` arrays of a reference checkpoint, prefix stripped.

    ``path`` is the checkpoint directory (holding ``arrays.npz``) or the
    ``.npz`` file itself.
    """
    if os.path.isdir(path):
        path = os.path.join(path, "arrays.npz")
    with np.load(path) as data:
        return {k[len(_PREFIX):]: data[k] for k in data.files
                if k.startswith(_PREFIX)}


@torch.no_grad()
def load_into(model, flat: dict[str, np.ndarray]) -> None:
    """Copy JAX-keyed arrays into ``model``; every parameter must be
    present with its shape, and no extra key may be given."""
    state = params_from_numpy(flat)
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    for name, p in own.items():
        src = state[name]
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{tuple(src.shape)} vs {tuple(p.shape)}")
        p.copy_(src.to(p.dtype))


@torch.no_grad()
def load_params(model, ds, buffers: dict, state0: torch.Tensor,
                ckpt: str | None = None, rounds: int = 4,
                seed: int = 0) -> None:
    """Checkpoint restore, or deterministic calibrated init.

    Without a checkpoint: calibrated init on ``state0`` with fixed
    generators (``seed`` for the weights, seed 1 for the conditioning
    noise sample), so the same (config, state0, device, seed) gives the
    same params.
    """
    if ckpt:
        load_into(model, load_arrays_npz(ckpt))
        return
    dev = model.device
    g_noise = torch.Generator(device=dev)
    g_noise.manual_seed(1)
    cond0 = torch.cat([ds.aux_fields(0.0)[None],
                       model.sample_noise(g_noise, (1,))], dim=1)
    g_init = torch.Generator(device=dev)
    g_init.manual_seed(seed)
    model.init_calibrated(g_init, state0[None], cond0, buffers, rounds)
