"""Config for ``llama4-maverick-400b-a17b`` (see
``repro_torch.configs.archs``)."""

from repro_torch.configs import archs


def config():
    """Full-scale configuration: 48 layers in 24 units of a dense layer
    (d_ff 16384) then a MoE layer (128 routed experts of d_ff 8192 top-1,
    1 shared), d_model 5120, GQA 40 / 8 heads of 128."""
    return archs.get_arch("llama4-maverick-400b-a17b")


def smoke():
    """Reduced same-family variant for CPU tests."""
    return archs.smoke_config("llama4-maverick-400b-a17b")
