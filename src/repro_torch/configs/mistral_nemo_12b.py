"""Config for ``mistral-nemo-12b`` (see ``repro_torch.configs.archs``)."""

from repro_torch.configs import archs


def config():
    """Full-scale configuration: 40 layers, d_model 5120, 32 query and 8 KV
    heads of 128."""
    return archs.get_arch("mistral-nemo-12b")


def smoke():
    """Reduced same-family variant for CPU tests."""
    return archs.smoke_config("mistral-nemo-12b")
