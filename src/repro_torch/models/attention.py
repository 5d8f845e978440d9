"""Attention for the LM zoo: GQA (grouped-query, with an optional sliding
window, and cross-attention) and MLA (multi-head latent attention with
an absorbed decode) [arXiv:2405.04434], as the JAX package's
``models/attention.py``.

Each variant has ``init`` (its weights drawn from a generator),
``apply_*_train`` (the whole sequence) and ``apply_*_decode`` (one query
token against a cache).  Caches are allocated at the maximum length; a
sliding window keeps a ring buffer of ``window`` slots.  Keys are rotated
(RoPE) before they are cached.

Numerics kept from the JAX package: the additive mask of ``NEG_INF``
(-1e30, not -inf), the softmax in float32, the scale ``1/sqrt(head_dim)``
(``1/sqrt(dn + dr)`` for MLA) and GQA's ``(B, H_kv, G, Sq, Sk)``
grouping of the query heads.  Attention is plain torch products, as the
JAX package computes it outside any Pallas kernel; no
``scaled_dot_product_attention``, which picks its own kernels and
precision on the card.

The full-sequence paths run in tiles of query rows: the score tensor of
``prefill_32k`` (B x 32 heads x 32768^2 x 4 B, 137 GB a sequence) cannot
be held.  A tile holds ``query_rows`` rows, so that its scores take at
most ``TILE_SCORE_BYTES``.  Each row still takes its softmax over every
key it may see; a tile skips only the keys the mask hides from all of
its rows (past its last row when causal, before the window of its first
row), whose weight exp(-1e30 - max) is exactly 0, so the result is the
same function.

Decode updates the cache in place and returns it (the JAX package
returns a new one): ``zamba2-2.7b``'s cache at a batch of 4 x 32768 is
24.5 GB, and a copy a step would double it.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Iterator, Mapping

import torch

from repro_torch.models import common as cm

NEG_INF = -1e30
#: the most one query tile's fp32 scores may take, 4 GiB; the
#: probabilities beside them double it (zamba2-2.7b's prefill at 1 x
#: 32768, 32 heads: 1024 rows a tile, 32 tiles a layer)
TILE_SCORE_BYTES = 1 << 32

Params = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    """One attention block's widths and options."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 1e4
    sliding_window: int = 0      # 0 = full attention
    causal: bool = True
    # MLA
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128


# ---------------------------------------------------------------------------
# Query tiles
# ---------------------------------------------------------------------------

def query_rows(batch: int, heads: int, s_k: int) -> int:
    """Query rows a tile takes so that its fp32 scores (batch x heads x
    rows x s_k) fit in ``TILE_SCORE_BYTES``; at least one."""
    return max(1, TILE_SCORE_BYTES // (4 * batch * heads * max(s_k, 1)))


def query_tiles(s_q: int, s_k: int, rows: int, causal: bool, window: int,
                ranged: bool) -> Iterator[tuple[int, int, int, int]]:
    """(q0, q1, k0, k1): each tile's query rows and the keys it reads.

    ``ranged`` (positions are 0..S-1 on both sides): a tile reads only
    keys some of its rows may see -- up to its last row when causal, from
    the first row's window on; otherwise every key.
    """
    for q0 in range(0, s_q, rows):
        q1 = min(s_q, q0 + rows)
        k0, k1 = 0, s_k
        if ranged:
            if causal:
                k1 = min(q1, s_k)
            if window:
                k0 = min(max(0, q0 - window + 1), k1)
        yield q0, q1, k0, k1


def scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                window: int) -> torch.Tensor:
    """(S_q, S_k) additive mask (0 or ``NEG_INF``) from absolute
    positions."""
    dq, dk = q_pos[:, None], k_pos[None, :]
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= dk <= dq
    if window:
        ok &= dk > dq - window
    return torch.where(ok, 0.0, NEG_INF)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def gqa_shapes(cfg: AttnConfig) -> dict[str, tuple[int, ...]]:
    """GQA's projections: wq, wk, wv (d_model -> heads x head_dim), wo."""
    d, hd = cfg.d_model, cfg.head_dim
    return {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
            "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}


def init_gqa(generator: torch.Generator, cfg: AttnConfig) -> dict:
    """GQA weights, each drawn as ``init_linear``."""
    return {name: cm.init_linear(generator, *shape)
            for name, shape in gqa_shapes(cfg).items()}


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, -1))


def apply_gqa_train(params: Params, cfg: AttnConfig, x: torch.Tensor,
                    positions: torch.Tensor | None = None,
                    kv_states: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence attention. x: (B, S, D) -> (B, S, D).

    ``kv_states`` (B, S_kv, D) switches to cross-attention: keys and
    values from the encoder states, not causal, no RoPE.
    """
    b, s, _ = x.shape
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // hkv
    pos = (positions if positions is not None
           else torch.arange(s, device=x.device))
    src = kv_states if kv_states is not None else x
    s_k = src.shape[1]
    kpos = (torch.arange(s_k, device=x.device) if kv_states is not None
            else pos)

    q = _split_heads(cm.linear(params["wq"], x), cfg.n_heads)
    k = _split_heads(cm.linear(params["wk"], src), hkv)
    v = _split_heads(cm.linear(params["wv"], src), hkv)
    if kv_states is None:  # self-attention: rotary embeddings
        q = cm.apply_rope(q, pos, cfg.rope_theta)
        k = cm.apply_rope(k, kpos, cfg.rope_theta)

    # (B, H_kv, S, G, D): a tile's G x rows merge into one operand row
    # axis without a copy; keys and values (B, H_kv, S_k, D)
    qg = q.reshape(b, s, hkv, g, hd).permute(0, 2, 1, 3, 4).contiguous()
    kt = k.permute(0, 2, 1, 3).contiguous()
    vt = v.permute(0, 2, 1, 3).contiguous()
    del q, k, v
    scale = float(1.0 / math.sqrt(hd))
    causal = cfg.causal and kv_states is None
    window = cfg.sliding_window
    rows = query_rows(b, cfg.n_heads, s_k)
    out = x.new_empty((b, s, hkv, g, hd))
    for q0, q1, k0, k1 in query_tiles(s, s_k, rows, causal, window,
                                      ranged=positions is None):
        t = q1 - q0
        qt = qg[:, :, q0:q1].reshape(b, hkv, t * g, hd)
        scores = torch.matmul(qt, kt[:, :, k0:k1].transpose(-1, -2))
        scores = (scores * scale).float().reshape(b, hkv, t, g, k1 - k0)
        scores += scores_mask(pos[q0:q1], kpos[k0:k1], causal,
                              window)[:, None, :]
        attn = torch.softmax(scores, dim=-1).to(vt.dtype)
        del scores
        o = torch.matmul(attn.reshape(b, hkv, t * g, k1 - k0),
                         vt[:, :, k0:k1])
        out[:, q0:q1] = o.reshape(b, hkv, t, g, hd).permute(0, 2, 1, 3, 4)
    return cm.linear(params["wo"], out.reshape(b, s, cfg.n_heads * hd))


def init_gqa_cache(cfg: AttnConfig, batch: int, max_len: int,
                   device=None) -> dict:
    """Zero keys and values (B, size, H_kv, D); size is the window when
    there is one, else ``max_len``."""
    size = cfg.sliding_window or max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, device=device),
            "v": torch.zeros(shape, device=device)}


def _slot_and_valid(pos: int, size: int, window: int, device
                    ) -> tuple[int, torch.Tensor]:
    """Where a decode step writes its key and which slots it reads: the
    ring buffer's ``pos % size`` and every slot once it has wrapped."""
    idx = torch.arange(size, device=device)
    if window:
        return pos % size, (idx <= pos % size) | (pos >= size)
    return pos, idx <= pos


def apply_gqa_decode(params: Params, cfg: AttnConfig, x: torch.Tensor,
                     cache: dict, pos,
                     kv_states: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, D); ``pos`` the absolute position (an
    int, or a 0-d tensor).  Writes the new key and value into ``cache``
    in place and returns it; cross-attention (``kv_states``) recomputes
    the encoder keys and values and leaves the cache as it is."""
    b = x.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(cm.linear(params["wq"], x), cfg.n_heads)

    if kv_states is not None:
        # cross-attention: static encoder states, no cache update, no rope
        k = _split_heads(cm.linear(params["wk"], kv_states), hkv)
        v = _split_heads(cm.linear(params["wv"], kv_states), hkv)
        valid = None
    else:
        pos = int(pos)
        p1 = torch.full((1,), pos, device=x.device)
        q = cm.apply_rope(q, p1, cfg.rope_theta)
        k_new = cm.apply_rope(
            _split_heads(cm.linear(params["wk"], x), hkv), p1, cfg.rope_theta)
        v_new = _split_heads(cm.linear(params["wv"], x), hkv)
        k, v = cache["k"], cache["v"]
        slot, valid = _slot_and_valid(pos, k.shape[1], cfg.sliding_window,
                                      x.device)
        k[:, slot] = k_new[:, 0].to(k.dtype)
        v[:, slot] = v_new[:, 0].to(v.dtype)

    g = cfg.n_heads // hkv
    qg = q.reshape(b, 1, hkv, g, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * float(
        1.0 / math.sqrt(hd))
    scores = scores.float()
    if valid is not None:
        scores = torch.where(valid, scores, NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", attn.to(v.dtype), v)
    out = out.reshape(b, 1, cfg.n_heads * hd)
    return cm.linear(params["wo"], out), cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v2)
# ---------------------------------------------------------------------------

def mla_shapes(cfg: AttnConfig) -> dict[str, tuple[int, ...]]:
    """MLA's projections: the latent down-projection (with the shared
    rotated key), the key, value and query up-projections, the output
    and, with a query rank, the query down-projection."""
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    out = {"w_dkv": (d, r + dr), "w_uk": (r, h * dn), "w_uv": (r, h * dv),
           "w_uq": (cfg.q_lora_rank or d, h * (dn + dr)), "wo": (h * dv, d)}
    if cfg.q_lora_rank:
        out["w_dq"] = (d, cfg.q_lora_rank)
    return out


def init_mla(generator: torch.Generator, cfg: AttnConfig) -> dict:
    """MLA weights, each drawn as ``init_linear``."""
    return {name: cm.init_linear(generator, *shape)
            for name, shape in mla_shapes(cfg).items()}


def _mla_qkv(params: Params, cfg: AttnConfig, x: torch.Tensor,
             pos: torch.Tensor):
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = cm.linear(params["w_dq"], x) if "w_dq" in params else x
    q = cm.linear(params["w_uq"], cq).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = cm.apply_rope(q_rope, pos, cfg.rope_theta)
    ckv = cm.linear(params["w_dkv"], x)                      # (B, S, r + dr)
    c_kv, k_rope = ckv[..., :cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    k_rope = cm.apply_rope(k_rope[..., None, :], pos,
                           cfg.rope_theta)[..., 0, :]
    return q_nope, q_rope, c_kv, k_rope


def apply_mla_train(params: Params, cfg: AttnConfig, x: torch.Tensor,
                    positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence causal MLA. x: (B, S, D) -> (B, S, D), in query
    tiles as GQA."""
    b, s, _ = x.shape
    h, dn, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    pos = (positions if positions is not None
           else torch.arange(s, device=x.device))
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, cfg, x, pos)
    k_nope = cm.linear(params["w_uk"], c_kv).reshape(b, s, h, dn)
    v = cm.linear(params["w_uv"], c_kv).reshape(b, s, h, dv)
    scale = float(1.0 / math.sqrt(dn + cfg.qk_rope_dim))
    window = cfg.sliding_window
    rows = query_rows(b, h, s)
    out = x.new_empty((b, s, h, dv))
    for q0, q1, k0, k1 in query_tiles(s, s, rows, True, window,
                                      ranged=positions is None):
        scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope[:, q0:q1],
                               k_nope[:, k0:k1])
                  + torch.einsum("bqhd,bkd->bhqk", q_rope[:, q0:q1],
                                 k_rope[:, k0:k1])) * scale
        scores = scores.float() + scores_mask(pos[q0:q1], pos[k0:k1], True,
                                              window)
        attn = torch.softmax(scores, dim=-1)
        del scores
        out[:, q0:q1] = torch.einsum("bhqk,bkhd->bqhd", attn.to(v.dtype),
                                     v[:, k0:k1])
    return cm.linear(params["wo"], out.reshape(b, s, h * dv))


def init_mla_cache(cfg: AttnConfig, batch: int, max_len: int,
                   device=None) -> dict:
    """MLA caches the latent ``c_kv`` and the shared rotated key (r + dr
    a token, not 2 H D: the memory saving that defines MLA)."""
    size = cfg.sliding_window or max_len
    return {"c_kv": torch.zeros((batch, size, cfg.kv_lora_rank),
                                device=device),
            "k_rope": torch.zeros((batch, size, cfg.qk_rope_dim),
                                  device=device)}


def apply_mla_decode(params: Params, cfg: AttnConfig, x: torch.Tensor,
                     cache: dict, pos) -> tuple[torch.Tensor, dict]:
    """Absorbed-matrices decode: scores and values in the latent space.

    x: (B, 1, D).  q_eff = q_nope W_uk (per head), so attention runs
    against the cached ``c_kv`` directly; W_uv applies after the
    probability-weighted sum of latents.  The cache is updated in place.
    """
    b = x.shape[0]
    h, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dv = cfg.qk_nope_dim, cfg.v_head_dim
    pos = int(pos)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(
        params, cfg, x, torch.full((1,), pos, device=x.device))
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    slot, valid = _slot_and_valid(pos, c_kv.shape[1], cfg.sliding_window,
                                  x.device)
    c_kv[:, slot] = c_kv_new[:, 0].to(c_kv.dtype)
    k_rope[:, slot] = k_rope_new[:, 0].to(k_rope.dtype)

    w_uk = params["w_uk"].reshape(r, h, dn)
    q_eff = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)      # absorb W_uk
    scale = float(1.0 / math.sqrt(dn + cfg.qk_rope_dim))
    scores = (torch.einsum("bqhr,bkr->bhqk", q_eff, c_kv)
              + torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope)) * scale
    scores = torch.where(valid, scores.float(), NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    lat = torch.einsum("bhqk,bkr->bqhr", attn.to(c_kv.dtype), c_kv)
    w_uv = params["w_uv"].reshape(r, h, dv)
    out = torch.einsum("bqhr,rhd->bqhd", lat, w_uv).reshape(b, 1, h * dv)
    return cm.linear(params["wo"], out), cache
