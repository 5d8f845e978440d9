"""Config for ``llava-next-34b`` (see ``repro_torch.configs.archs``)."""

from repro_torch.configs import archs


def config():
    """Full-scale configuration: 60 layers, d_model 7168, 56 query and 8 KV
    heads, 2880 patches."""
    return archs.get_arch("llava-next-34b")


def smoke():
    """Reduced same-family variant for CPU tests."""
    return archs.smoke_config("llava-next-34b")
