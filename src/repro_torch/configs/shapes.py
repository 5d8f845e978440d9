"""The LM zoo's four input shapes and the per-shape architecture tweaks.

  train_4k     seq_len=4096    global_batch=256   -> train step
  prefill_32k  seq_len=32768   global_batch=32    -> prefill (full forward)
  decode_32k   seq_len=32768   global_batch=128   -> serve step (1 token
                                                     against a cache of
                                                     seq_len)
  long_500k    seq_len=524288  global_batch=1     -> serve step; attention
                architectures switch to a sliding window of 8192

The JAX package builds ShapeDtypeStruct stand-ins from these for its
compile-only dry run; the port allocates real tensors, so it keeps the
shapes only.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import ArchConfig

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
