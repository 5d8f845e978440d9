"""Checkpoints in the JAX package's format (paper G.3).

A checkpoint is ``{directory}/ckpt_{step:08d}/`` holding

* ``arrays.npz`` -- every tensor on the host, keyed by its JAX tree path:
  ``params/blocks/0/conv/w_re``, ``opt_state/step``,
  ``opt_state/mu/blocks/0/conv/w_re``, ...;
* ``manifest.json`` -- ``step``, the sorted ``keys``, per-key
  ``shardings`` (advisory) and ``extra`` metadata.

The JAX package's ``restore_checkpoint`` reads what ``save_checkpoint``
writes here, and ``restore_checkpoint`` here reads what it writes.  The
name mapping between the port's dotted parameter names and the tree
paths lives in ``repro_torch.inference.params``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.inference import params as paramslib


def save_checkpoint(directory: str, step: int,
                    params: dict[str, torch.Tensor],
                    opt_state: dict | None = None,
                    shardings: dict[str, list[str | None]] | None = None,
                    extra: dict | None = None) -> str:
    """Write ``{directory}/ckpt_{step:08d}/{arrays.npz, manifest.json}``.

    ``params`` maps the port's parameter names to tensors (for a model,
    ``dict(model.named_parameters())``); ``opt_state`` is an
    ``optim.adam.Adam`` state.  Returns the checkpoint directory.
    """
    path = os.path.join(directory, f"ckpt_{step:08d}")
    os.makedirs(path, exist_ok=True)
    flat = {f"params/{k}": v
            for k, v in paramslib.params_to_numpy(params).items()}
    if opt_state is not None:
        flat.update({f"opt_state/{k}": v for k, v in
                     paramslib.opt_state_to_numpy(opt_state).items()})
    np.savez(os.path.join(path, "arrays.npz"), **flat)
    manifest = {"step": step, "keys": sorted(flat),
                "shardings": shardings or {}, "extra": extra or {}}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return path


def latest_checkpoint(directory: str) -> str | None:
    """The newest ``ckpt_*`` directory under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    cands = sorted(d for d in os.listdir(directory) if d.startswith("ckpt_"))
    return os.path.join(directory, cands[-1]) if cands else None


def restore_checkpoint(path: str, device: str | torch.device = "cpu"
                       ) -> tuple[dict[str, torch.Tensor], dict | None, dict]:
    """Read a checkpoint written by either package.

    Returns ``(params, opt_state, manifest)``: ``params`` keyed by the
    port's parameter names, ``opt_state`` an ``Adam`` state (None when
    the checkpoint has none), all on ``device``.
    """
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}

    def part(prefix: str) -> dict[str, np.ndarray]:
        return {k[len(prefix):]: v for k, v in arrays.items()
                if k.startswith(prefix)}

    params = {k: v.to(device) for k, v in
              paramslib.params_from_numpy(part("params/")).items()}
    opt = part("opt_state/")
    opt_state = (paramslib.opt_state_from_numpy(opt, device) if opt
                 else None)
    return params, opt_state, manifest
