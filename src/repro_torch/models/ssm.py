"""Mamba-2 (SSD, state-space duality) mixer [arXiv:2405.21060].

The prefill runs the chunked SSD algorithm: quadratic within a chunk,
a linear recurrence across chunks.  Its intra-chunk step goes through
``kernels.dispatch.ssd_chunked``, which picks the CUDA kernel or the
plain einsum scan below (``ssd_chunked``).  Decoding runs the O(1)
recurrent state update in plain torch.

Numerics kept from the JAX package:

* ``softplus`` is ``log1p(exp(-|x|)) + relu(x)``, the form of
  ``jax.nn.softplus`` (``logaddexp(x, 0)``); ``F.softplus`` would switch
  to the identity above its threshold of 20;
* the causal convolution is the shifted sum of ``ssm.py:64-69``, not
  ``F.conv1d`` (cuDNN would bring TF32 and a library kernel);
* the mixer's gated RMSNorm uses ``rmsnorm``'s default eps of 1e-6; the
  layer norms around the mixer use the architecture's ``norm_eps``.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import torch
import torch.nn.functional as F

from repro_torch.kernels.config import KernelConfig
from repro_torch.models import common as cm

Params = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Widths of one Mamba-2 mixer."""

    d_model: int
    d_state: int = 128
    head_dim: int = 64           # P
    expand: int = 2
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        """Width of the inner (expanded) stream."""
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        """Number of SSD heads."""
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        """Channels through the causal convolution: x, B and C."""
        return self.d_inner + 2 * self.n_groups * self.d_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) without a threshold."""
    return torch.log1p(torch.exp(-x.abs())) + torch.relu(x)


def init_mamba2(generator: torch.Generator, cfg: SSMConfig) -> dict:
    """A mixer's parameters, drawn as the JAX package's ``init_mamba2``."""
    dev = generator.device
    d_in, h = cfg.d_inner, cfg.n_heads
    in_proj = cm.init_linear(generator, *_shapes(cfg)["in_proj"])
    conv_w = (torch.randn((cfg.d_conv, cfg.conv_dim), generator=generator,
                          device=dev) * float(1.0 / math.sqrt(cfg.d_conv)))
    # dt = exp(U(log 1e-3, log 1e-1)); dt_bias = softplus^-1(dt)
    u = torch.rand((h,), generator=generator, device=dev)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((cfg.conv_dim,), device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "d_skip": torch.ones((h,), device=dev),
        "dt_bias": torch.log(torch.expm1(dt)),
        "norm": cm.init_rmsnorm(d_in, dev),
        "out_proj": cm.init_linear(generator, d_in, cfg.d_model),
    }


class Mamba2(cm.Params):
    """A mixer's parameters as an ``nn.Module`` (names as in the JAX tree:
    ``in_proj``, ``conv_w``, ``conv_b``, ``a_log``, ``d_skip``,
    ``dt_bias``, ``norm``, ``out_proj``)."""

    def __init__(self, cfg: SSMConfig, device=None):
        super().__init__(_shapes(cfg), device)
        self.cfg = cfg

    def reset(self, generator: torch.Generator) -> None:
        """Draw fresh parameters from ``generator``."""
        self.load(init_mamba2(generator, self.cfg))


def _shapes(cfg: SSMConfig) -> dict[str, tuple[int, ...]]:
    d_in, h = cfg.d_inner, cfg.n_heads
    proj_out = 2 * d_in + 2 * cfg.n_groups * cfg.d_state + h
    return {"in_proj": (cfg.d_model, proj_out),
            "conv_w": (cfg.d_conv, cfg.conv_dim), "conv_b": (cfg.conv_dim,),
            "a_log": (h,), "d_skip": (h,), "dt_bias": (h,),
            "norm": (d_in,), "out_proj": (d_in, cfg.d_model)}


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d as a shifted sum. xbc: (B, S, C); w: (K, C)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:s, :] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s, :] * w[i]
    return out + b


def _segsum_decay(da_cs: torch.Tensor) -> torch.Tensor:
    """Lower-triangular decay L[l, s] = exp(cs_l - cs_s) for s <= l, else 0.

    da_cs: (..., L, H) inclusive cumsum of dA within a chunk -> (..., L,
    L, H).  The mask is applied before ``exp``.
    """
    diff = da_cs[..., :, None, :] - da_cs[..., None, :, :]
    ll = da_cs.shape[-2]
    tri = torch.ones((ll, ll), dtype=torch.bool, device=da_cs.device).tril()
    return diff.masked_fill(~tri[..., None], float("-inf")).exp()


def ssd_chunked(x: torch.Tensor, da: torch.Tensor, b_mat: torch.Tensor,
                c_mat: torch.Tensor, chunk: int,
                initial_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, the plain reference path.

    x: (B, S, H, P) inputs already scaled by dt; da: (B, S, H) A * dt
    (negative); b_mat, c_mat: (B, S, G, N).  Returns (y (B, S, H, P),
    final_state (B, H, P, N)).
    """
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    rep = h // g

    def chunked(t, tail):
        return t.reshape((bsz, nc, chunk) + tail)

    xc = chunked(x, (h, p))
    dac = chunked(da, (h,))
    bc = chunked(b_mat, (g, n))
    cc = chunked(c_mat, (g, n))

    da_cs = torch.cumsum(dac, dim=2)                         # (B,nc,L,H)
    # --- intra-chunk (quadratic, the "attention-like" dual form)
    decay = _segsum_decay(da_cs)                             # (B,nc,L,L,H)
    cb = torch.einsum("bclgn,bcsgn->bclsg", cc, bc)          # (B,nc,L,L,G)
    cb = cb.repeat_interleave(rep, dim=-1)                   # groups -> heads
    att = cb * decay
    y_diag = torch.einsum("bclsh,bcshp->bclhp", att, xc)

    # --- chunk states
    decay_states = torch.exp(da_cs[:, :, -1:, :] - da_cs)    # (B,nc,L,H)
    bex = bc.repeat_interleave(rep, dim=-2)                  # (B,nc,L,H,N)
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", bex, decay_states, xc)

    # --- inter-chunk recurrence (linear scan over chunks)
    chunk_decay = torch.exp(da_cs[:, :, -1, :])              # (B,nc,H)
    carry = (torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)
             if initial_state is None else initial_state)
    prev = []
    for i in range(nc):
        prev.append(carry)  # the state *entering* chunk i
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                   # (B,nc,H,P,N)

    # --- contribution of the incoming state to each position
    state_decay = torch.exp(da_cs)                           # (B,nc,L,H)
    cex = cc.repeat_interleave(rep, dim=-2)
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", cex, prev_states,
                         state_decay)
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y, carry


def _split_proj(zxbcdt: torch.Tensor, cfg: SSMConfig):
    d_in = cfg.d_inner
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + cfg.conv_dim],
            zxbcdt[..., d_in + cfg.conv_dim:])


def apply_mamba2_train(params: Params, cfg: SSMConfig, u: torch.Tensor,
                       kernels: KernelConfig | None = None) -> torch.Tensor:
    """Full-sequence mixer (training / prefill). u: (B, S, D) -> (B, S, D).

    S is padded with zeros to a multiple of ``cfg.chunk`` for the scan
    (the padded tail is causal and sliced away).  ``kernels.ssd`` picks
    the scan: the CUDA kernel path (default) or the plain einsum scan.
    """
    from repro_torch.kernels import dispatch  # dispatch imports this module
    bsz, s, _ = u.shape
    h, p, n, g = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    d_in = cfg.d_inner
    z, xbc, dt = _split_proj(cm.linear(params["in_proj"], u), cfg)
    xbc = F.silu(_causal_conv(xbc, params["conv_w"], params["conv_b"]))
    x = xbc[..., :d_in].reshape(bsz, s, h, p)
    b_mat = xbc[..., d_in:d_in + g * n].reshape(bsz, s, g, n)
    c_mat = xbc[..., d_in + g * n:].reshape(bsz, s, g, n)
    dt = softplus(dt + params["dt_bias"])                    # (B,S,H)
    a = -torch.exp(params["a_log"])                          # (H,)
    xs, das = x * dt[..., None], dt * a
    pad = -s % cfg.chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        das = F.pad(das, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    y, _ = dispatch.ssd_chunked(xs, das, b_mat, c_mat, cfg.chunk,
                                kernels or KernelConfig())
    y = y[:, :s] + params["d_skip"][:, None] * x
    y = y.reshape(bsz, s, d_in)
    y = cm.rmsnorm(params["norm"], y * F.silu(z))
    return cm.linear(params["out_proj"], y)


def init_mamba2_cache(cfg: SSMConfig, batch: int, device=None) -> dict:
    """Empty recurrent state (B, H, P, N) and conv window (B, K-1, C)."""
    return {
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                           device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.conv_dim),
                            device=device),
    }


def apply_mamba2_decode(params: Params, cfg: SSMConfig, u: torch.Tensor,
                        cache: dict) -> tuple[torch.Tensor, dict]:
    """One-token recurrent step. u: (B, 1, D) -> (B, 1, D), new cache."""
    bsz = u.shape[0]
    h, p, n, g = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    d_in = cfg.d_inner
    z, xbc, dt = _split_proj(cm.linear(params["in_proj"], u[:, 0]), cfg)

    # conv ring buffer
    window = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)
    conv_out = (torch.einsum("bkc,kc->bc", window, params["conv_w"])
                + params["conv_b"])
    xbc = F.silu(conv_out)
    new_conv = window[:, 1:]

    x = xbc[..., :d_in].reshape(bsz, h, p)
    b_mat = xbc[..., d_in:d_in + g * n].reshape(bsz, g, n)
    c_mat = xbc[..., d_in + g * n:].reshape(bsz, g, n)
    rep = h // g
    bex = b_mat.repeat_interleave(rep, dim=1)                 # (B,H,N)
    cex = c_mat.repeat_interleave(rep, dim=1)
    dt = softplus(dt + params["dt_bias"])                     # (B,H)
    a = -torch.exp(params["a_log"])
    da = torch.exp(dt * a)                                    # (B,H)
    state = (cache["ssm"] * da[..., None, None]
             + torch.einsum("bh,bhp,bhn->bhpn", dt, x, bex))
    y = torch.einsum("bhpn,bhn->bhp", state, cex)
    y = y + params["d_skip"][:, None] * x
    y = y.reshape(bsz, d_in)
    y = cm.rmsnorm(params["norm"], y * F.silu(z))
    out = cm.linear(params["out_proj"], y)[:, None, :]
    return out, {"ssm": state, "conv": new_conv}
