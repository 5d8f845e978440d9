"""The LM zoo's 10 architectures, as the JAX package's table states them.

Pure data: each entry cites its source.  ``get_arch`` returns the
full-scale ``ArchConfig`` and ``smoke_config`` a reduced same-family
variant (<=2 layers, d_model<=512, <=4 experts) for CPU tests.  The
port's ``LM`` builds every one of them.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import ArchConfig

# ---------------------------------------------------------------------------
# Full-scale configs
# ---------------------------------------------------------------------------

ARCHS: dict[str, ArchConfig] = {}


def _register(cfg: ArchConfig) -> ArchConfig:
    """Add ``cfg`` to ``ARCHS`` under its name."""
    ARCHS[cfg.name] = cfg
    return cfg


# [ssm] SSD (state-space duality) [arXiv:2405.21060]
MAMBA2_130M = _register(ArchConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    vocab_size=50280,
    ssm=SSMConfig(d_model=768, d_state=128, head_dim=64, expand=2,
                  n_groups=1, chunk=128),
    source="arXiv:2405.21060",
))

# [dense] RoPE SwiGLU GQA [arXiv:2404.14219]
PHI3_MINI = _register(ArchConfig(
    name="phi3-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, head_dim=96, d_ff=8192, vocab_size=32064,
    rope_theta=1e4, source="arXiv:2404.14219",
))

# [dense] 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407]
MISTRAL_NEMO = _register(ArchConfig(
    name="mistral-nemo-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=131072,
    rope_theta=1e6, source="hf:mistralai/Mistral-Nemo-Base-2407",
))

# [moe] MLA kv_lora=512, 2 shared + 160 routed top-6 [arXiv:2405.04434]
DEEPSEEK_V2 = _register(ArchConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv_heads=128, d_ff=12288,  # d_ff: the single dense layer
    vocab_size=102400, mla=True, kv_lora_rank=512, q_lora_rank=1536,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, n_dense_layers=1,
    moe=MoEConfig(d_model=5120, d_ff=1536, n_experts=160, top_k=6,
                  n_shared=2, shared_d_ff=2 * 1536),
    source="arXiv:2405.04434",
))

# [dense] llama-arch GQA [arXiv:2403.04652]
YI_6B = _register(ArchConfig(
    name="yi-6b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=4, head_dim=128, d_ff=11008, vocab_size=64000,
    rope_theta=5e6, source="arXiv:2403.04652",
))

# [dense] qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B]
CODEQWEN = _register(ArchConfig(
    name="codeqwen1.5-7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, head_dim=128, d_ff=13440, vocab_size=92416,
    rope_theta=1e6, source="hf:Qwen/CodeQwen1.5-7B",
))

# [hybrid] Mamba2 + shared attn blocks [arXiv:2411.15242]
ZAMBA2 = _register(ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, head_dim=80, d_ff=10240, vocab_size=32000,
    attn_every=6,
    ssm=SSMConfig(d_model=2560, d_state=64, head_dim=64, expand=2,
                  n_groups=1, chunk=128),
    source="arXiv:2411.15242",
))

# [vlm] anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf]
LLAVA_NEXT = _register(ArchConfig(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, head_dim=128, d_ff=20480, vocab_size=64000,
    rope_theta=5e6, n_patches=2880,  # anyres: 5 tiles x 576 patches
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
))

# [audio] enc-dec, conv frontend (stub) [arXiv:2212.04356]
WHISPER_SMALL = _register(ArchConfig(
    name="whisper-small", family="audio", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=51865,
    mlp_kind="gelu", n_encoder_layers=12, encoder_seq=1500,
    source="arXiv:2212.04356",
))

# [moe] 128e top-1, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E]
LLAMA4_MAVERICK = _register(ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
    d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128, d_ff=16384,
    vocab_size=202048, rope_theta=5e5, moe_every=2,  # MoE on alternate layers
    moe=MoEConfig(d_model=5120, d_ff=8192, n_experts=128, top_k=1,
                  n_shared=1, shared_d_ff=8192),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))


# ---------------------------------------------------------------------------
# Reduced smoke variants (same family/features, tiny dims)
# ---------------------------------------------------------------------------

def smoke_config(name: str) -> ArchConfig:
    """The reduced same-family variant of ``name``."""
    full = ARCHS[name]
    small_ssm = (SSMConfig(d_model=128, d_state=16, head_dim=32, expand=2,
                           n_groups=1, chunk=16) if full.ssm else None)
    small_moe = (dataclasses.replace(
        full.moe, d_model=128, d_ff=64,
        n_experts=4, top_k=min(full.moe.top_k, 2),
        n_shared=min(full.moe.n_shared, 1), shared_d_ff=64,
    ) if full.moe else None)
    n_layers = 2
    kw: dict = dict(
        name=full.name + "-smoke", d_model=128, d_ff=256, vocab_size=256,
        n_layers=n_layers, head_dim=32,
        n_heads=4, n_kv_heads=max(1, 4 * full.n_kv_heads
                                  // max(full.n_heads, 1)),
        ssm=small_ssm, moe=small_moe,
    )
    if full.family == "hybrid":
        kw.update(n_layers=2, attn_every=2)
    if full.family == "moe":
        kw.update(n_dense_layers=min(full.n_dense_layers, 1),
                  moe_every=full.moe_every,
                  n_layers=(2 * full.moe_every
                            + min(full.n_dense_layers, 1)))
    if full.mla:
        kw.update(kv_lora_rank=32, q_lora_rank=48, qk_nope_dim=32,
                  qk_rope_dim=16, v_head_dim=32)
    if full.family == "audio":
        kw.update(n_encoder_layers=2, encoder_seq=16)
    if full.family == "vlm":
        kw.update(n_patches=8)
    return dataclasses.replace(full, **kw)


def get_arch(name: str) -> ArchConfig:
    """The full-scale configuration of ``name``."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
