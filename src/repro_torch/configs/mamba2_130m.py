"""Config for ``mamba2-130m`` (see ``repro_torch.configs.archs``)."""

from repro_torch.configs import archs


def config():
    """Full-scale configuration: 24 layers, d_model 768, d_state 128."""
    return archs.get_arch("mamba2-130m")


def smoke():
    """Reduced same-family variant for CPU tests."""
    return archs.smoke_config("mamba2-130m")
