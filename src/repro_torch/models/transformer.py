"""LM assembly of the port: ``ArchConfig`` and the ``LM`` module.

``ArchConfig`` describes any of the JAX package's six families (dense /
moe / ssm / hybrid / vlm / audio).  ``LM`` assembles the ``ssm`` family
(Mamba-2 layers: pre-norm residual around the mixer) and refuses the
others, which come with attention and the MoE FFN (ROADMAP A13).

* ``LM.forward`` is the JAX package's ``apply_train`` logits (the
  prefill of ``launch/dryrun.py``), under ``torch.no_grad``;
* ``LM.decode_step`` is one token against the recurrent cache (its
  ``serve_step``).  It writes each layer's new state into the cache in
  place, where the JAX package returns a new cache: at a batch of 128
  the ``mamba2-130m`` cache is 2.4 GB, and a copy per step would double
  it.

Parameters carry the JAX tree's names with the stacked layer axis split:
``layers/mixer/in_proj`` (24, 768, 3352) becomes
``layers.{i}.mixer.in_proj`` (``models/params.py`` converts).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels.config import KernelConfig
from repro_torch.models import common as cm
from repro_torch.models import moe as moelib
from repro_torch.models import ssm as ssmlib
from repro_torch.runtime import resolve_device

#: the families ``LM`` assembles so far
FAMILIES = ("ssm",)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture of the LM zoo, as the JAX package's ``ArchConfig``
    (its ``attn_config`` comes with attention, ROADMAP A13)."""

    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    rope_theta: float = 1e4
    sliding_window: int = 0
    norm_eps: float = 1e-5
    mlp_kind: str = "swiglu"     # swiglu | gelu
    # --- MoE
    moe: moelib.MoEConfig | None = None
    n_dense_layers: int = 0      # leading layers with a dense FFN
    moe_every: int = 1           # 2 = alternate dense/MoE (llama4-style)
    # --- MLA (deepseek)
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- SSM / hybrid
    ssm: ssmlib.SSMConfig | None = None
    attn_every: int = 0          # hybrid: shared attn block per N ssm layers
    # --- enc-dec (audio)
    n_encoder_layers: int = 0
    encoder_seq: int = 1500      # whisper: 30 s of audio at 50 Hz
    # --- vlm stub
    n_patches: int = 0
    source: str = ""

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as the JAX package pads it
        (Megatron-style) for the embedding and the LM head."""
        return -(-self.vocab_size // 256) * 256


# ---------------------------------------------------------------------------
# SSM layers
# ---------------------------------------------------------------------------

class SSMLayer(nn.Module):
    """Pre-norm residual Mamba-2 layer: ``ln`` (RMSNorm gain), ``mixer``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.ln = nn.Parameter(cm.init_rmsnorm(cfg.d_model, device),
                               requires_grad=False)
        self.mixer = ssmlib.Mamba2(cfg.ssm, device=device)


def init_ssm_layer(layer: SSMLayer, generator: torch.Generator) -> None:
    """Fresh layer parameters: unit norm gain, a freshly drawn mixer."""
    with torch.no_grad():
        layer.ln.fill_(1.0)
    layer.mixer.reset(generator)


def apply_ssm_layer_train(layer: SSMLayer, cfg: ArchConfig, x: torch.Tensor,
                          kernels: KernelConfig | None = None
                          ) -> torch.Tensor:
    """x (B, S, D) -> x + mixer(rmsnorm(x)) over the whole sequence."""
    h = cm.rmsnorm(layer.ln, x, cfg.norm_eps)
    return x + ssmlib.apply_mamba2_train(layer.mixer.params(), cfg.ssm, h,
                                         kernels)


def apply_ssm_layer_decode(layer: SSMLayer, cfg: ArchConfig, x: torch.Tensor,
                           cache: dict) -> tuple[torch.Tensor, dict]:
    """One token: x (B, 1, D) -> (B, 1, D) and the layer's new cache."""
    h = cm.rmsnorm(layer.ln, x, cfg.norm_eps)
    o, cache = ssmlib.apply_mamba2_decode(layer.mixer.params(), cfg.ssm, h,
                                          cache)
    return x + o, cache


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """Decoder-only LM per ``ArchConfig``; family ``ssm`` so far.

    Parameters: ``embed`` (V_pad, D), ``ln_out`` (D), ``lm_head`` (D,
    V_pad) and ``layers`` (an ``nn.ModuleList`` of ``SSMLayer``).  Built
    on ``device`` (``cuda`` unless the caller asks for the CPU) with zero
    weights; ``init`` draws them.  ``kernels.ssd`` picks the prefill's
    chunked scan.
    """

    def __init__(self, cfg: ArchConfig, device=None,
                 kernels: KernelConfig | None = None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"LM family {cfg.family!r} ({cfg.name}) is not ported yet; "
                f"the port has {FAMILIES} (attention, dense, MoE, hybrid, "
                "VLM and audio families are ROADMAP A13)")
        dev = resolve_device(device)
        self.cfg = cfg
        self.kernels = kernels or KernelConfig()
        v, d = cfg.padded_vocab, cfg.d_model
        self.embed = nn.Parameter(torch.zeros((v, d), device=dev),
                                  requires_grad=False)
        self.ln_out = nn.Parameter(cm.init_rmsnorm(d, dev),
                                   requires_grad=False)
        self.lm_head = nn.Parameter(torch.zeros((d, v), device=dev),
                                    requires_grad=False)
        self.layers = nn.ModuleList(SSMLayer(cfg, dev)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        """The device the parameters live on."""
        return self.embed.device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator`` (on the model's device),
        with the JAX package's distributions."""
        cfg = self.cfg
        self.embed.copy_(cm.init_embedding(generator, cfg.padded_vocab,
                                           cfg.d_model))
        self.ln_out.fill_(1.0)
        self.lm_head.copy_(cm.init_linear(generator, cfg.d_model,
                                          cfg.padded_vocab))
        for layer in self.layers:
            init_ssm_layer(layer, generator)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence logits: tokens (B, S) int -> (B, S, V_pad) fp32."""
        cfg = self.cfg
        x = cm.embed(self.embed, tokens)
        for layer in self.layers:
            x = apply_ssm_layer_train(layer, cfg, x, self.kernels)
        x = cm.rmsnorm(self.ln_out, x, cfg.norm_eps)
        return cm.linear(self.lm_head, x)

    def init_cache(self, batch: int, max_len: int = 0) -> dict:
        """Empty caches, stacked over layers as in the JAX package:
        ``{"layers": {"ssm": (n_layers, B, H, P, N), "conv": (n_layers,
        B, K-1, C)}}``.  The SSM cache does not grow with ``max_len``."""
        one = ssmlib.init_mamba2_cache(self.cfg.ssm, batch, self.device)
        return {"layers": {k: v[None].repeat((self.cfg.n_layers,)
                                             + (1,) * v.dim())
                           for k, v in one.items()}}

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: dict,
                    pos: torch.Tensor | int | None = None
                    ) -> tuple[torch.Tensor, dict]:
        """tokens (B, 1) -> logits (B, 1, V_pad) and ``cache``, updated in
        place.  ``pos`` is accepted for the JAX signature; the recurrent
        state does not need it."""
        cfg = self.cfg
        x = cm.embed(self.embed, tokens)
        stacked = cache["layers"]
        for i, layer in enumerate(self.layers):
            x, new = apply_ssm_layer_decode(
                layer, cfg, x, {k: v[i] for k, v in stacked.items()})
            for k, v in new.items():
                stacked[k][i].copy_(v)
        x = cm.rmsnorm(self.ln_out, x, cfg.norm_eps)
        return cm.linear(self.lm_head, x), cache

    def param_count(self) -> int:
        """Number of parameters (padded vocab included)."""
        return sum(p.numel() for p in self.parameters())
