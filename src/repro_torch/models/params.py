"""LM weights carried across from and to the JAX package.

The JAX ``LM`` keeps its layers stacked: ``layers/mixer/in_proj`` has a
leading axis of ``n_layers``, the audio encoder's ``enc_layers/...`` one
of ``n_encoder_layers``, the MoE family's ``dense_layers/...`` one of
``n_dense_layers`` and its ``layers/...`` one per MoE layer, and
llama4's ``unit_dense/...`` two, (units, ``moe_every - 1``).
``lm_params_from_numpy`` takes that tree flattened to numpy arrays keyed
by tree path (as ``repro.train.checkpoint._flatten_with_paths`` writes
it) and returns the port's ``state_dict``, with each stacked axis split
(``layers.{i}.mixer.in_proj``, ``enc_layers.{i}.attn.wq``,
``unit_dense.{u}.{i}.attn.wq``) and the other nested keys joined with
dots (the hybrid's shared block ``shared_attn/attn/wq`` ->
``shared_attn.attn.wq``, an expert layer's ``layers/ffn/shared/w_up``
-> ``layers.{i}.ffn.shared.w_up``); ``lm_params_to_numpy`` stacks them
back.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch


def _stacks(cfg) -> dict[str, tuple[int, ...]]:
    """The stacked trees and the depths of their stacked axes."""
    if cfg.family != "moe":
        return {"layers": (cfg.n_layers,),
                "enc_layers": (cfg.n_encoder_layers,)}
    n_rest = cfg.n_layers - cfg.n_dense_layers
    out = {"dense_layers": (cfg.n_dense_layers,)}
    if cfg.moe_every > 1:
        units = n_rest // cfg.moe_every
        out.update(layers=(units,), unit_dense=(units, cfg.moe_every - 1))
    else:
        out["layers"] = (n_rest,)
    return out


def lm_params_from_numpy(flat: dict[str, np.ndarray], cfg
                         ) -> dict[str, torch.Tensor]:
    """JAX tree-path keys -> the port's ``LM`` ``state_dict`` keys."""
    out = {}
    stacks = _stacks(cfg)
    for key, val in flat.items():
        arr = np.asarray(val)
        top, _, rest = key.partition("/")
        if top in stacks and rest:
            depths = stacks[top]
            if arr.shape[:len(depths)] != depths:
                raise ValueError(f"{key}: leading axes "
                                 f"{arr.shape[:len(depths)]} are not the "
                                 f"{depths} layers of {top}")
            rest = rest.replace("/", ".")
            for idx in itertools.product(*map(range, depths)):
                name = ".".join(map(str, (top,) + idx + (rest,)))
                out[name] = torch.from_numpy(np.array(arr[idx]))
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
            parts = rest.split(".")
            n = len(stacks[top])
            idx = tuple(int(i) for i in parts[:n])
            per_layer.setdefault((top, ".".join(parts[n:])), {})[idx] = arr
        else:
            out[key.replace(".", "/")] = arr
    for (top, rest), layers in per_layer.items():
        depths = stacks[top]
        want = list(itertools.product(*map(range, depths)))
        if sorted(layers) != want:
            raise ValueError(f"{top}.*.{rest}: have layers {sorted(layers)}"
                             f", want {depths}")
        stacked = np.stack([layers[i] for i in want])
        out[f"{top}/" + rest.replace(".", "/")] = stacked.reshape(
            depths + stacked.shape[1:])
    return out
