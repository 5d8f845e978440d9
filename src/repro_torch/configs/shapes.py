"""The LM zoo's four input shapes and the per-shape architecture tweaks.

  train_4k     seq_len=4096    global_batch=256   -> train step
  prefill_32k  seq_len=32768   global_batch=32    -> prefill (full forward)
  decode_32k   seq_len=32768   global_batch=128   -> serve step (1 token
                                                     against a cache of
                                                     seq_len)
  long_500k    seq_len=524288  global_batch=1     -> serve step; attention
                architectures switch to a sliding window of 8192

``input_specs`` gives the stand-ins of one step's inputs as ``meta``
tensors (shape and dtype, no data), the counterpart of the JAX package's
ShapeDtypeStructs; the dry run (``launch/dryrun.py``) reads them.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.transformer import LM, ArchConfig

SLIDING_WINDOW_LONG = 8192


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One input shape: sequence length, global batch and step kind."""

    name: str
    seq_len: int
    global_batch: int
    mode: str                    # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def adapt_arch_for_shape(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """Per-shape architecture adjustments.

    ``long_500k`` on attention architectures switches to sliding-window
    attention; SSM architectures keep an O(1) state and need no change.
    """
    if shape.name == "long_500k" and cfg.n_heads:
        cfg = dataclasses.replace(cfg, sliding_window=SLIDING_WINDOW_LONG)
    return cfg


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape,
                dtype: torch.dtype = torch.float32) -> dict:
    """``meta`` stand-ins for every model input of one step.

    Train and prefill: ``tokens`` and ``labels`` (B, S_text) int32, with
    ``patches`` (vlm) and ``enc_frames`` (audio).  Decode: ``tokens`` (B,
    1), ``pos`` () and the cache ``LM.init_cache(B, S)`` on ``meta`` (the
    MoE family's with its ``dense_layers`` and ``unit_dense`` stacks),
    with ``enc_states`` (audio).
    """
    b, s = shape.global_batch, shape.seq_len
    if shape.mode in ("train", "prefill"):
        s_text = s - (cfg.n_patches if cfg.family == "vlm" else 0)
        specs = {"tokens": _meta((b, s_text), torch.int32),
                 "labels": _meta((b, s_text), torch.int32)}
        if cfg.family == "vlm":
            specs["patches"] = _meta((b, cfg.n_patches, cfg.d_model), dtype)
        if cfg.family == "audio":
            specs["enc_frames"] = _meta((b, cfg.encoder_seq, cfg.d_model),
                                        dtype)
        return specs
    model = LM(cfg, device="meta")
    specs = {"tokens": _meta((b, 1), torch.int32),
             "cache": model.init_cache(b, s),
             "pos": _meta((), torch.int32)}
    if cfg.family == "audio":
        specs["enc_states"] = _meta((b, cfg.encoder_seq, cfg.d_model), dtype)
    return specs
