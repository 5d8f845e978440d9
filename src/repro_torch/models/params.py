"""LM weights carried across from and to the JAX package.

The JAX ``LM`` keeps its layers stacked: ``layers/mixer/in_proj`` has a
leading axis of ``n_layers`` and the audio encoder's ``enc_layers/...``
one of ``n_encoder_layers``.  ``lm_params_from_numpy`` takes that tree
flattened to numpy arrays keyed by tree path (as
``repro.train.checkpoint._flatten_with_paths`` writes it) and returns the
port's ``state_dict``, with each stacked axis split
(``layers.{i}.mixer.in_proj``, ``enc_layers.{i}.attn.wq``) and the
other nested keys joined with dots (the hybrid's shared block
``shared_attn/attn/wq`` -> ``shared_attn.attn.wq``);
``lm_params_to_numpy`` stacks them back.
"""

from __future__ import annotations

import numpy as np
import torch


def _stacks(cfg) -> dict[str, int]:
    """The stacked trees and their depths."""
    return {"layers": cfg.n_layers, "enc_layers": cfg.n_encoder_layers}


def lm_params_from_numpy(flat: dict[str, np.ndarray], cfg
                         ) -> dict[str, torch.Tensor]:
    """JAX tree-path keys -> the port's ``LM`` ``state_dict`` keys."""
    out = {}
    stacks = _stacks(cfg)
    for key, val in flat.items():
        arr = np.asarray(val)
        top, _, rest = key.partition("/")
        if top in stacks and rest:
            if arr.shape[0] != stacks[top]:
                raise ValueError(f"{key}: leading axis {arr.shape[0]} is not "
                                 f"the {stacks[top]} layers of {top}")
            rest = rest.replace("/", ".")
            for i in range(stacks[top]):
                out[f"{top}.{i}.{rest}"] = torch.from_numpy(np.array(arr[i]))
        else:
            out[key.replace("/", ".")] = torch.from_numpy(np.array(arr))
    return out


def lm_params_to_numpy(params: dict[str, torch.Tensor], cfg
                       ) -> dict[str, np.ndarray]:
    """The port's ``state_dict`` -> JAX tree-path keys, layers stacked."""
    out, per_layer = {}, {}
    stacks = _stacks(cfg)
    for key, val in params.items():
        arr = val.detach().cpu().numpy()
        top, _, rest = key.partition(".")
        if top in stacks and rest:
            idx, rest = rest.split(".", 1)
            per_layer.setdefault((top, rest), {})[int(idx)] = arr
        else:
            out[key.replace(".", "/")] = arr
    for (top, rest), layers in per_layer.items():
        if sorted(layers) != list(range(stacks[top])):
            raise ValueError(f"{top}.*.{rest}: have layers {sorted(layers)}"
                             f", want {stacks[top]}")
        out[f"{top}/" + rest.replace(".", "/")] = np.stack(
            [layers[i] for i in range(stacks[top])])
    return out
