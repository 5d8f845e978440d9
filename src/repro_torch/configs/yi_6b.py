"""Config for ``yi-6b`` (see ``repro_torch.configs.archs``)."""

from repro_torch.configs import archs


def config():
    """Full-scale configuration: 32 layers, d_model 4096, 32 query and 4 KV
    heads of 128."""
    return archs.get_arch("yi-6b")


def smoke():
    """Reduced same-family variant for CPU tests."""
    return archs.smoke_config("yi-6b")
