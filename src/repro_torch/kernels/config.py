"""Kernel-dispatch configuration: which path executes each hot op.

FCN3's two dominant contractions -- the Legendre stage of the SHT and the
banded DISCO convolution -- and the chunked SSD scan of the Mamba-2 LMs
each have two implementations in the port:

* ``reference`` -- the plain torch FFT/einsum paths in
  ``repro_torch.core.sphere`` over the full psi tensor, and
  ``repro_torch.models.ssm.ssd_chunked``;
* ``kernel``    -- the banded buffer layout and the hand-written CUDA
  kernels behind ``repro_torch.kernels.legendre`` / ``.disco``, and
  ``repro_torch.kernels.ssd.ops.ssd_chunked_kernel``.

There is no silent degrade: ``kernel`` on a CPU tensor runs the kernel
wrapper's plain version because the tensor lies on the CPU, and on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses

MODES = ("reference", "kernel")
OPS = ("sht", "disco", "ssd")


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Per-op path selection; frozen and hashable so it nests in configs.

    sht / disco / ssd: "reference" | "kernel".  ``ssd`` is the last
    field, so ``KernelConfig(sht, disco)`` keeps its meaning.
    """

    sht: str = "kernel"
    disco: str = "kernel"
    ssd: str = "kernel"

    def __post_init__(self):
        for op in OPS:
            if getattr(self, op) not in MODES:
                raise ValueError(f"KernelConfig.{op} must be one of {MODES}, "
                                 f"got {getattr(self, op)!r}")
