"""LM assembly of the port: ``ArchConfig`` and the ``LM`` module.

``ArchConfig`` describes any of the JAX package's six families, and
``LM`` assembles each of them:

* ``dense``: pre-norm decoder layers (attention, then a SwiGLU or GELU
  MLP);
* ``moe``: ``n_dense_layers`` leading dense layers (``dense_layers``),
  then decoder layers whose FFN is the mixture of experts
  (``models/moe.py``): ``n_layers - n_dense_layers`` of them
  (deepseek-v2, ``layers``), or with ``moe_every > 1`` units of
  ``moe_every - 1`` dense layers (``unit_dense``) each followed by one
  MoE layer (llama4, ``layers``);
* ``vlm``: the same as ``dense``, with the ``patches`` embeddings (the
  projector output, a stub) prepended to the embedded tokens;
* ``ssm``: Mamba-2 layers (pre-norm residual around the mixer);
* ``hybrid`` (Zamba2): ``n_layers / attn_every`` units of
  ``attn_every`` Mamba-2 layers, each unit followed by one *shared*
  decoder layer (one parameter set, one KV cache per unit);
* ``audio`` (Whisper): a non-causal encoder over ``enc_frames`` (a stub
  of the conv front end), whose self-attention still takes RoPE, then
  decoder layers that cross-attend to the encoder states.

* ``LM.apply_train`` is the JAX package's ``apply_train``: logits and the
  aux (the MoE layers' mean load-balance loss and router entropy, zeros
  for the other families), differentiable; with ``remat`` (on by
  default, as the JAX ``LM``'s) and grad enabled, each layer -- each
  hybrid unit, each llama4 unit -- runs under
  ``torch.utils.checkpoint`` and runs again in the backward (the JAX
  package's ``jax.checkpoint`` over its layer scans; the audio encoder
  is not checkpointed there either);
* ``LM.loss`` is its ``loss``: the next-token cross-entropy on the text
  logits plus 0.01 x the load-balance loss, and {"ce", "lb_loss",
  "router_entropy"};
* ``LM.forward`` is ``apply_train``'s logits alone (the prefill of
  ``launch/lm.py`` and ``launch/dryrun.py``), under ``torch.no_grad``,
  so that no prefill keeps activations for a backward;
* ``LM.decode_step`` is one token against the caches (its
  ``serve_step``).  It writes each layer's new state and key / value
  into the cache in place, where the JAX package returns a new cache: at
  a batch of 128 the ``mamba2-130m`` cache is 2.4 GB, and
  ``zamba2-2.7b``'s KV caches at 4 x 32768 take 24.5 GB; a copy per step
  would double them.

Both take ``moe_group``: the data ranks of which the call's batch is
this rank's slice (``moe.scatter_group``); MoE layers of
``dispatch="scatter"`` dispatch over them.  And ``expert_group``: the
model-axis ranks over which ``place_experts`` put the MoE layers'
experts (each rank holding its E/n of every stack); both dispatches run
the rank's experts and gather their outputs over it (``moe._experts``).

Parameters carry the JAX tree's names with the stacked layer axes split:
``layers/mixer/in_proj`` (24, 768, 3352) becomes
``layers.{i}.mixer.in_proj``, ``enc_layers/attn/wq`` becomes
``enc_layers.{i}.attn.wq``, llama4's ``unit_dense/attn/wq`` (units, 1,
D, H hd) ``unit_dense.{u}.{i}.attn.wq``, and the hybrid's one
``shared_attn/attn/wq`` is ``shared_attn.attn.wq`` (``models/params.py``
converts).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.kernels.config import KernelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import moe as moelib
from repro_torch.models import ssm as ssmlib
from repro_torch.runtime import resolve_device

#: the families ``LM`` assembles: all of the JAX package's
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture of the LM zoo, as the JAX package's
    ``ArchConfig``."""

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

    def attn_config(self, causal: bool = True,
                    sliding_window: int | None = None) -> attn.AttnConfig:
        """The attention block's configuration (``head_dim`` defaults to
        d_model / n_heads; ``sliding_window`` to the architecture's)."""
        hd = self.head_dim or (self.d_model // max(self.n_heads, 1))
        return attn.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=hd,
            rope_theta=self.rope_theta, causal=causal,
            sliding_window=(self.sliding_window if sliding_window is None
                            else sliding_window),
            mla=self.mla, kv_lora_rank=self.kv_lora_rank,
            q_lora_rank=self.q_lora_rank, qk_rope_dim=self.qk_rope_dim,
            qk_nope_dim=self.qk_nope_dim, v_head_dim=self.v_head_dim)


# ---------------------------------------------------------------------------
# Decoder layers (attention + MLP, pre-norm residual)
# ---------------------------------------------------------------------------

def _attn_shapes(acfg: attn.AttnConfig) -> dict:
    return attn.mla_shapes(acfg) if acfg.mla else attn.gqa_shapes(acfg)


def _ffn_shapes(cfg: ArchConfig) -> dict:
    if cfg.mlp_kind == "gelu":
        return cm.gelu_mlp_shapes(cfg.d_model, cfg.d_ff)
    return cm.swiglu_shapes(cfg.d_model, cfg.d_ff)


class DecoderLayer(nn.Module):
    """Pre-norm decoder layer: ``ln_attn``, ``attn`` (GQA or MLA),
    ``ln_ffn``, ``ffn`` (the MLP, or with ``use_moe`` the mixture of
    experts) and, with ``cross``, ``ln_cross`` and ``cross`` (GQA over
    encoder states)."""

    def __init__(self, cfg: ArchConfig, cross: bool = False, device=None,
                 use_moe: bool = False):
        super().__init__()
        d = cfg.d_model

        def gain():
            return nn.Parameter(cm.init_rmsnorm(d, device),
                                requires_grad=False)
        self.ln_attn = gain()
        self.attn = cm.Params(_attn_shapes(cfg.attn_config()), device)
        self.ln_ffn = gain()
        self.ffn = (moelib.MoE(cfg.moe, device) if use_moe
                    else cm.Params(_ffn_shapes(cfg), device))
        if cross:
            self.ln_cross = gain()
            self.cross = cm.Params(
                attn.gqa_shapes(cfg.attn_config(causal=False)), device)


def init_decoder_layer(layer: DecoderLayer, cfg: ArchConfig,
                       generator: torch.Generator) -> None:
    """Fresh layer parameters: unit norm gains, attention and MLP (or
    experts, drawn in place) weights drawn as the JAX package's
    ``init_decoder_layer``."""
    acfg = cfg.attn_config()
    with torch.no_grad():
        for name in ("ln_attn", "ln_ffn", "ln_cross"):
            if hasattr(layer, name):
                getattr(layer, name).fill_(1.0)
    layer.attn.load(attn.init_mla(generator, acfg) if acfg.mla
                    else attn.init_gqa(generator, acfg))
    if isinstance(layer.ffn, moelib.MoE):
        moelib.init_moe(layer.ffn, generator)
    else:
        layer.ffn.load(
            cm.init_gelu_mlp(generator, cfg.d_model, cfg.d_ff)
            if cfg.mlp_kind == "gelu"
            else cm.init_swiglu(generator, cfg.d_model, cfg.d_ff))
    if hasattr(layer, "cross"):
        layer.cross.load(attn.init_gqa(generator,
                                       cfg.attn_config(causal=False)))


def _apply_ffn(layer: DecoderLayer, cfg: ArchConfig, x: torch.Tensor,
               moe_group=None, expert_group=None
               ) -> tuple[torch.Tensor, dict]:
    """The layer's FFN and its aux (zeros without experts)."""
    p = layer.ffn.params()
    if isinstance(layer.ffn, moelib.MoE):
        return moelib.apply_moe(p, cfg.moe, x, moe_group, expert_group)
    y = cm.gelu_mlp(p, x) if cfg.mlp_kind == "gelu" else cm.swiglu(p, x)
    return y, moelib.zero_aux(x.device)


def apply_decoder_layer_train(layer: DecoderLayer, cfg: ArchConfig,
                              x: torch.Tensor,
                              enc: torch.Tensor | None = None,
                              acfg: attn.AttnConfig | None = None,
                              moe_group=None, expert_group=None
                              ) -> tuple[torch.Tensor, dict]:
    """x (B, S, D) -> (B, S, D) over the whole sequence, and the FFN's
    aux; ``enc`` (B, S_enc, D) feeds the cross block where the layer has
    one.  ``acfg`` overrides the self-attention's configuration (the
    audio encoder's: not causal, no window)."""
    acfg = acfg or cfg.attn_config()
    h = cm.rmsnorm(layer.ln_attn, x, cfg.norm_eps)
    if acfg.mla:
        x = x + attn.apply_mla_train(layer.attn.params(), acfg, h)
    else:
        x = x + attn.apply_gqa_train(layer.attn.params(), acfg, h)
    if enc is not None and hasattr(layer, "cross"):
        h = cm.rmsnorm(layer.ln_cross, x, cfg.norm_eps)
        x = x + attn.apply_gqa_train(layer.cross.params(),
                                     cfg.attn_config(False), h,
                                     kv_states=enc)
    h = cm.rmsnorm(layer.ln_ffn, x, cfg.norm_eps)
    y, aux = _apply_ffn(layer, cfg, h, moe_group, expert_group)
    return x + y, aux


def apply_decoder_layer_decode(layer: DecoderLayer, cfg: ArchConfig,
                               x: torch.Tensor, cache: dict, pos,
                               enc: torch.Tensor | None = None,
                               moe_group=None, expert_group=None
                               ) -> tuple[torch.Tensor, dict]:
    """One token: x (B, 1, D) -> (B, 1, D); ``cache`` ({"self": ...}) is
    updated in place and returned."""
    acfg = cfg.attn_config()
    h = cm.rmsnorm(layer.ln_attn, x, cfg.norm_eps)
    if acfg.mla:
        o, _ = attn.apply_mla_decode(layer.attn.params(), acfg, h,
                                     cache["self"], pos)
    else:
        o, _ = attn.apply_gqa_decode(layer.attn.params(), acfg, h,
                                     cache["self"], pos)
    x = x + o
    if enc is not None and hasattr(layer, "cross"):
        h = cm.rmsnorm(layer.ln_cross, x, cfg.norm_eps)
        o, _ = attn.apply_gqa_decode(layer.cross.params(),
                                     cfg.attn_config(False), h, {}, pos,
                                     kv_states=enc)
        x = x + o
    h = cm.rmsnorm(layer.ln_ffn, x, cfg.norm_eps)
    y, _ = _apply_ffn(layer, cfg, h, moe_group, expert_group)
    return x + y, cache


def init_layer_cache(cfg: ArchConfig, batch: int, max_len: int,
                     device=None) -> dict:
    """One decoder layer's empty cache: {"self": keys and values (GQA) or
    latents and rotated keys (MLA)}."""
    acfg = cfg.attn_config()
    if acfg.mla:
        return {"self": attn.init_mla_cache(acfg, batch, max_len, device)}
    return {"self": attn.init_gqa_cache(acfg, batch, max_len, device)}


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

def _stack_views(stacked: dict, i: int) -> dict:
    """Entry ``i`` of a cache stacked over layers (nested dicts): views,
    so writes land in the stacked tensors."""
    return {k: _stack_views(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _stack(one: dict, *dims: int) -> dict:
    """Copies of a cache stacked on new leading axes of sizes ``dims``
    (one allocation each: llama4's stacks over (units, moe_every - 1)
    take no nested temporary)."""
    return {k: _stack(v, *dims) if isinstance(v, dict)
            else v.expand(dims + tuple(v.shape)).clone()
            for k, v in one.items()}


def _chain(group: list, x: torch.Tensor) -> tuple[torch.Tensor, list]:
    """x through each callable of ``group`` in turn, and the auxes they
    gave (``LM.apply_train``'s checkpointed body)."""
    auxs = []
    for f in group:
        x, aux = f(x)
        if aux is not None:
            auxs.append(aux)
    return x, auxs


class LM(nn.Module):
    """Decoder-only (or encoder-decoder) LM per ``ArchConfig``, every
    family of the JAX package.

    Parameters: ``embed`` (V_pad, D), ``ln_out`` (D), ``lm_head`` (D,
    V_pad), ``layers`` (an ``nn.ModuleList`` of ``DecoderLayer`` or, for
    ``ssm`` and ``hybrid``, ``SSMLayer``; for ``moe`` the MoE layers),
    the MoE family's ``dense_layers`` and ``unit_dense`` (a list of
    units, each a list of dense layers), the hybrid's ``shared_attn``
    (one ``DecoderLayer``) and the audio family's ``enc_layers``.  Built
    on ``device`` (``cuda`` unless the caller asks for the CPU) with zero
    weights; ``init`` draws them.  ``kernels.ssd`` picks the chunked
    scan; ``remat`` checkpoints the layers on the grad path.  The
    parameters do not require grad until the caller asks for it
    (``requires_grad_``, as ``train/lm.py`` does).
    """

    def __init__(self, cfg: ArchConfig, device=None,
                 kernels: KernelConfig | None = None, remat: bool = True):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.name}: unknown LM family "
                             f"{cfg.family!r}; have {FAMILIES}")
        dev = resolve_device(device)
        self.cfg = cfg
        self.kernels = kernels or KernelConfig()
        self.remat = remat
        #: the parameters held as this rank's block (``place_experts``)
        self.placed: set[str] = set()
        v, d = cfg.padded_vocab, cfg.d_model
        self.embed = nn.Parameter(torch.zeros((v, d), device=dev),
                                  requires_grad=False)
        self.ln_out = nn.Parameter(cm.init_rmsnorm(d, dev),
                                   requires_grad=False)
        self.lm_head = nn.Parameter(torch.zeros((d, v), device=dev),
                                    requires_grad=False)
        fam = cfg.family
        self.n_units = 0

        def decoder_layers(n, **kw):
            return nn.ModuleList(DecoderLayer(cfg, device=dev, **kw)
                                 for _ in range(n))
        if fam in ("ssm", "hybrid"):
            self.layers = nn.ModuleList(SSMLayer(cfg, dev)
                                        for _ in range(cfg.n_layers))
        elif fam == "moe":
            nd, every = cfg.n_dense_layers, cfg.moe_every
            n_rest = cfg.n_layers - nd
            if cfg.moe is None or n_rest <= 0 or n_rest % every:
                raise ValueError(
                    f"{cfg.name}: a MoE stack needs experts and n_layers - "
                    f"n_dense_layers ({cfg.n_layers} - {nd}) a positive "
                    f"multiple of moe_every {every}")
            if nd:
                self.dense_layers = decoder_layers(nd)
            if every > 1:
                # llama4: units of (moe_every - 1) dense layers, each
                # followed by one MoE layer
                self.n_units = n_rest // every
                self.unit_dense = nn.ModuleList(
                    decoder_layers(every - 1) for _ in range(self.n_units))
            self.layers = decoder_layers(self.n_units or n_rest,
                                         use_moe=True)
        else:
            self.layers = decoder_layers(cfg.n_layers, cross=fam == "audio")
        if fam == "hybrid":
            if not cfg.attn_every or cfg.n_layers % cfg.attn_every:
                raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is "
                                 f"not a multiple of attn_every "
                                 f"{cfg.attn_every}")
            self.n_units = cfg.n_layers // cfg.attn_every
            # Zamba2: one *shared* attention block reused across units
            self.shared_attn = DecoderLayer(cfg, device=dev)
        if fam == "audio":
            self.enc_layers = decoder_layers(cfg.n_encoder_layers)

    @property
    def device(self) -> torch.device:
        """The device the parameters live on."""
        return self.embed.device

    def _decoder_layers(self) -> list[DecoderLayer]:
        """Every decoder layer but the shared and encoder ones, in the
        order a forward runs them."""
        out = list(getattr(self, "dense_layers", ()))
        if hasattr(self, "unit_dense"):
            for unit, moe_layer in zip(self.unit_dense, self.layers):
                out += list(unit) + [moe_layer]
        else:
            out += list(self.layers)
        return out

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator`` (on the model's device),
        with the JAX package's distributions; the embedding, the head and
        the experts are drawn in place (no temporary of their size)."""
        cfg = self.cfg
        # the JAX package's init_embedding (normal x 0.02) and the head's
        # init_linear (normal x 1/sqrt(D))
        self.embed.normal_(generator=generator).mul_(0.02)
        self.ln_out.fill_(1.0)
        self.lm_head.normal_(generator=generator).mul_(
            1.0 / math.sqrt(cfg.d_model))
        for layer in self._decoder_layers():
            if isinstance(layer, SSMLayer):
                init_ssm_layer(layer, generator)
            else:
                init_decoder_layer(layer, cfg, generator)
        if hasattr(self, "shared_attn"):
            init_decoder_layer(self.shared_attn, cfg, generator)
        for layer in getattr(self, "enc_layers", ()):
            init_decoder_layer(layer, cfg, generator)

    def _encode_audio(self, frames: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        acfg = cfg.attn_config(causal=False, sliding_window=0)
        x = frames
        for layer in self.enc_layers:
            x, _ = apply_decoder_layer_train(layer, cfg, x, acfg=acfg)
        return x

    @torch.no_grad()
    def encode_audio(self, frames: torch.Tensor) -> torch.Tensor:
        """The Whisper encoder over precomputed conv front-end frames (a
        stub): self-attention not causal, no window, RoPE kept."""
        return self._encode_audio(frames)

    def apply_train(self, tokens: torch.Tensor,
                    patches: torch.Tensor | None = None,
                    enc_frames: torch.Tensor | None = None,
                    moe_group=None, expert_group=None
                    ) -> tuple[torch.Tensor, dict]:
        """Full-sequence logits and aux, as the JAX package's
        ``apply_train``: tokens (B, S) int -> (B, S', V_pad) fp32, and
        {"lb_loss", "router_entropy"}, the mean over the MoE layers (zeros
        for the other families).

        ``vlm``: ``patches`` (B, P, D) are prepended (S' = P + S).
        ``audio``: ``enc_frames`` (B, S_enc, D) go through the encoder
        first, and every decoder layer cross-attends to its output.
        ``moe_group``, ``expert_group``: see the module docstring.
        """
        cfg = self.cfg
        x = cm.embed(self.embed, tokens)
        fam = cfg.family
        if fam == "vlm" and patches is not None:
            x = torch.cat([patches.to(x.dtype), x], dim=1)

        # the layers in groups, the JAX package's scan bodies: lists of
        # callables x -> (x, aux or None)
        def ssm(layer):
            return lambda x: (apply_ssm_layer_train(layer, cfg, x,
                                                    self.kernels), None)

        def dec(layer, enc=None, moe=False):
            def f(x):
                y, aux = apply_decoder_layer_train(
                    layer, cfg, x, enc=enc, moe_group=moe_group,
                    expert_group=expert_group)
                return y, aux if moe else None
            return f

        if fam == "ssm":
            groups = [[ssm(layer)] for layer in self.layers]
        elif fam == "hybrid":
            ae = cfg.attn_every
            groups = [[ssm(layer) for layer in self.layers[u * ae:
                                                           (u + 1) * ae]]
                      + [dec(self.shared_attn)] for u in range(self.n_units)]
        elif fam == "moe":
            groups = [[dec(layer)]
                      for layer in getattr(self, "dense_layers", ())]
            for i, layer in enumerate(self.layers):
                unit = self.unit_dense[i] if hasattr(self, "unit_dense") else ()
                groups.append([dec(d) for d in unit] + [dec(layer, moe=True)])
        else:
            enc = (self._encode_audio(enc_frames) if fam == "audio"
                   else None)
            groups = [[dec(layer, enc)] for layer in self.layers]
        remat = self.remat and torch.is_grad_enabled()
        auxs = []
        for group in groups:
            if remat:
                # nothing inside is kept for the backward, which runs the
                # group again
                x, aux = ckpt.checkpoint(_chain, group, x,
                                         use_reentrant=False,
                                         preserve_rng_state=False)
                auxs += aux
                continue
            # a flat loop: no reference to a layer's input outlives it (a
            # prefill holds one residual stream at a time)
            for f in group:
                x, aux = f(x)
                if aux is not None:
                    auxs.append(aux)
        x = cm.rmsnorm(self.ln_out, x, cfg.norm_eps)
        logits = cm.linear(self.lm_head, x)
        if not auxs:
            return logits, moelib.zero_aux(logits.device)
        return logits, {k: torch.stack([a[k] for a in auxs]).mean()
                        for k in auxs[0]}

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor,
             patches: torch.Tensor | None = None,
             enc_frames: torch.Tensor | None = None, moe_group=None,
             expert_group=None) -> tuple[torch.Tensor, dict]:
        """The JAX package's ``LM.loss``: next-token cross-entropy on the
        text logits (the last S of them: a VLM's patches come first),
        logits at t against labels at t + 1, plus 0.01 x the MoE layers'
        load-balance loss.  Returns (loss, {"ce", "lb_loss",
        "router_entropy"})."""
        logits, aux = self.apply_train(tokens, patches, enc_frames,
                                       moe_group, expert_group)
        s = tokens.shape[1]
        ce = cm.cross_entropy_loss(logits[:, -s:][:, :-1], labels[:, 1:])
        return ce + 0.01 * aux["lb_loss"], {"ce": ce, **aux}

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                patches: torch.Tensor | None = None,
                enc_frames: torch.Tensor | None = None,
                moe_group=None, expert_group=None) -> torch.Tensor:
        """``apply_train``'s logits alone."""
        return self.apply_train(tokens, patches, enc_frames, moe_group,
                                expert_group)[0]

    def init_cache(self, batch: int, max_len: int = 0) -> dict:
        """Empty caches, stacked over layers as in the JAX package:
        ``{"layers": {"self": {"k", "v"}}}`` (n_layers, B, size, H_kv, D)
        for the attention families (``c_kv`` / ``k_rope`` under MLA; for
        ``moe`` ``layers`` holds the MoE layers' caches, beside
        ``dense_layers`` (n_dense_layers, ...) and ``unit_dense`` (units,
        moe_every - 1, ...)); ``{"layers": {"ssm": (n_layers, B, H, P,
        N), "conv": (n_layers, B, K-1, C)}}`` for ``ssm``, and for
        ``hybrid`` beside it ``"shared_attn": {"self": {"k", "v"}}``
        (n_units, B, max_len, H_kv, D).  The SSM cache does not grow with
        ``max_len``."""
        cfg, dev = self.cfg, self.device
        if cfg.family in ("ssm", "hybrid"):
            cache = {"layers": _stack(
                ssmlib.init_mamba2_cache(cfg.ssm, batch, dev), cfg.n_layers)}
            if self.n_units:
                cache["shared_attn"] = _stack(
                    init_layer_cache(cfg, batch, max_len, dev), self.n_units)
            return cache
        one = init_layer_cache(cfg, batch, max_len, dev)
        cache = {"layers": _stack(one, len(self.layers))}
        if hasattr(self, "unit_dense"):
            cache["unit_dense"] = _stack(one, self.n_units,
                                         cfg.moe_every - 1)
        if hasattr(self, "dense_layers"):
            cache["dense_layers"] = _stack(one, len(self.dense_layers))
        return cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: dict, pos=None,
                    enc_states: torch.Tensor | None = None, moe_group=None,
                    expert_group=None) -> tuple[torch.Tensor, dict]:
        """tokens (B, 1) -> logits (B, 1, V_pad) and ``cache``, updated in
        place.  ``pos`` is the absolute position of the token (an int or
        a 0-d tensor; the recurrent state does not need it).  ``audio``:
        ``enc_states`` (B, S_enc, D) are the encoder's output
        (``encode_audio``), whose keys and values every step computes
        again, as the JAX package does; ``vlm`` takes no patches here.
        ``moe_group``, ``expert_group``: see the module docstring."""
        cfg = self.cfg
        fam = cfg.family
        if pos is None and fam != "ssm":
            raise ValueError(f"{cfg.name}: decode_step needs the token's "
                             "position")
        x = cm.embed(self.embed, tokens)
        if fam in ("ssm", "hybrid"):
            stacked = cache["layers"]
            ae = cfg.attn_every if fam == "hybrid" else cfg.n_layers
            for i, layer in enumerate(self.layers):
                x, new = apply_ssm_layer_decode(layer, cfg, x,
                                                _stack_views(stacked, i))
                for k, v in new.items():
                    stacked[k][i].copy_(v)
                if fam == "hybrid" and (i + 1) % ae == 0:
                    x, _ = apply_decoder_layer_decode(
                        self.shared_attn, cfg, x,
                        _stack_views(cache["shared_attn"], i // ae), pos)
        else:
            enc = enc_states if fam == "audio" else None

            def step(layer, x, layer_cache):
                return apply_decoder_layer_decode(
                    layer, cfg, x, layer_cache, pos, enc=enc,
                    moe_group=moe_group, expert_group=expert_group)[0]
            for i, layer in enumerate(getattr(self, "dense_layers", ())):
                x = step(layer, x, _stack_views(cache["dense_layers"], i))
            for i, layer in enumerate(self.layers):
                if hasattr(self, "unit_dense"):
                    unit = _stack_views(cache["unit_dense"], i)
                    for j, dense in enumerate(self.unit_dense[i]):
                        x = step(dense, x, _stack_views(unit, j))
                x = step(layer, x, _stack_views(cache["layers"], i))
        x = cm.rmsnorm(self.ln_out, x, cfg.norm_eps)
        return cm.linear(self.lm_head, x), cache

    def place_experts(self, mesh, axis: str = "model") -> list[str]:
        """Put the MoE stacks' experts over the mesh axis ``axis``, as the
        JAX package's ``lm_param_specs`` places them
        (``sharding.lm_expert_specs``, sanitized): each stack is replaced
        by this rank's block of E/n experts; returns the names placed
        (also kept in ``placed``).  Calls then pass the axis's group as
        ``expert_group``."""
        from repro_torch.distributed import sharding
        params = dict(self.named_parameters())
        specs = sharding.sanitize_specs(
            mesh, sharding.lm_expert_specs(self.cfg, params,
                                           model_axis=axis), params)
        self.placed = set(sharding.place_parameters(self, specs, mesh))
        return sorted(self.placed)

    def param_count(self) -> int:
        """Number of parameters (padded vocab included)."""
        return sum(p.numel() for p in self.parameters())
