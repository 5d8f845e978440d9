"""Config for ``zamba2-2.7b`` (see ``repro_torch.configs.archs``)."""

from repro_torch.configs import archs


def config():
    """Full-scale configuration: 54 Mamba-2 layers, d_model 2560, a shared
    attention block every 6."""
    return archs.get_arch("zamba2-2.7b")


def smoke():
    """Reduced same-family variant for CPU tests."""
    return archs.smoke_config("zamba2-2.7b")
