"""Config for ``whisper-small`` (see ``repro_torch.configs.archs``)."""

from repro_torch.configs import archs


def config():
    """Full-scale configuration: 12 encoder and 12 decoder layers, d_model 768,
    1500 frames."""
    return archs.get_arch("whisper-small")


def smoke():
    """Reduced same-family variant for CPU tests."""
    return archs.smoke_config("whisper-small")
