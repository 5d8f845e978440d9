"""Meshes of ranks on ``torch.distributed.device_mesh.init_device_mesh``.

Each is a function, so importing this module touches no device and no
process group.  The axis order follows the JAX package: the fastest
varying (``"model"``) axis holds neighbouring ranks, the paper's §G.1
rule of keeping the all-to-all-heavy communicators on the closest links.
The default process group must be up before a mesh is made.
"""

from __future__ import annotations


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the world
    (row-major: the last axis varies fastest over the ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 x 16 (256 ranks) or 2 x 16 x 16 (512 ranks), as the JAX
    package's production meshes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_toy_mesh(n_data: int = 4, n_model: int = 2,
                  device_type: str = "cpu"):
    """A small ``("data", "model")`` mesh for tests on the CPU."""
    return make_mesh((n_data, n_model), ("data", "model"), device_type)


def data_axes(mesh) -> tuple[str, ...]:
    """All pure data-parallel axes of a mesh."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
