"""Config for ``phi3-mini-3.8b`` (see ``repro_torch.configs.archs``)."""

from repro_torch.configs import archs


def config():
    """Full-scale configuration: 32 layers, d_model 3072, 32 query and 32 KV
    heads of 96."""
    return archs.get_arch("phi3-mini-3.8b")


def smoke():
    """Reduced same-family variant for CPU tests."""
    return archs.smoke_config("phi3-mini-3.8b")
