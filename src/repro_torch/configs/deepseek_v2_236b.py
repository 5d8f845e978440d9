"""Config for ``deepseek-v2-236b`` (see ``repro_torch.configs.archs``)."""

from repro_torch.configs import archs


def config():
    """Full-scale configuration: 60 layers (one dense, 59 MoE), d_model
    5120, MLA (128 heads, kv_lora 512, q_lora 1536), 160 routed experts of
    d_ff 1536 top-6 and 2 shared."""
    return archs.get_arch("deepseek-v2-236b")


def smoke():
    """Reduced same-family variant for CPU tests."""
    return archs.smoke_config("deepseek-v2-236b")
