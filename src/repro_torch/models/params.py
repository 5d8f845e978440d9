"""LM weights carried across from and to the JAX package.

The JAX ``LM`` keeps its layers stacked: ``layers/mixer/in_proj`` has a
leading axis of ``n_layers``.  ``lm_params_from_numpy`` takes that tree
flattened to numpy arrays keyed by tree path (as
``repro.train.checkpoint._flatten_with_paths`` writes it) and returns the
port's ``state_dict``, with the stacked axis split into
``layers.{i}.mixer.in_proj``; ``lm_params_to_numpy`` stacks them back.
"""

from __future__ import annotations

import numpy as np
import torch

_LAYERS = "layers/"


def lm_params_from_numpy(flat: dict[str, np.ndarray], cfg
                         ) -> dict[str, torch.Tensor]:
    """JAX tree-path keys -> the port's ``LM`` ``state_dict`` keys."""
    out = {}
    for key, val in flat.items():
        arr = np.asarray(val)
        if key.startswith(_LAYERS):
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{key}: leading axis {arr.shape[0]} is not "
                                 f"n_layers={cfg.n_layers}")
            rest = key[len(_LAYERS):].replace("/", ".")
            for i in range(cfg.n_layers):
                out[f"layers.{i}.{rest}"] = torch.from_numpy(np.array(arr[i]))
        else:
            out[key.replace("/", ".")] = torch.from_numpy(np.array(arr))
    return out


def lm_params_to_numpy(params: dict[str, torch.Tensor], cfg
                       ) -> dict[str, np.ndarray]:
    """The port's ``state_dict`` -> JAX tree-path keys, layers stacked."""
    out, per_layer = {}, {}
    for key, val in params.items():
        arr = val.detach().cpu().numpy()
        if key.startswith("layers."):
            _, idx, rest = key.split(".", 2)
            per_layer.setdefault(rest, {})[int(idx)] = arr
        else:
            out[key.replace(".", "/")] = arr
    for rest, layers in per_layer.items():
        if sorted(layers) != list(range(cfg.n_layers)):
            raise ValueError(f"layers.*.{rest}: have layers {sorted(layers)}"
                             f", want {cfg.n_layers}")
        out[_LAYERS + rest.replace(".", "/")] = np.stack(
            [layers[i] for i in range(cfg.n_layers)])
    return out
