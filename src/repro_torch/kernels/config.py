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

``BlockConfig`` carries a kernel family's tile constants: the values a
build passes as ``-DTUNE_<NAME>`` to that family's CUDA source
(``BLOCK_SOURCES``), tuned per card by ``kernels.autotune``.  An empty
``KernelConfig.blocks`` launches the committed kernels.  The plain
versions on the CPU compute the same function whatever the tile.
"""

from __future__ import annotations

import dataclasses

MODES = ("reference", "kernel")
OPS = ("sht", "disco", "ssd")

#: kernel families with a tunable tile: the Legendre contraction (both
#: SHT directions), the band contraction, its transpose, the CRPS kernels
#: (forward and backward: one source) and the SSD intra-chunk step
BLOCK_OPS = ("legendre", "disco", "disco_bwd", "crps", "ssd")

#: the CUDA source (``kernels.build`` name) each family's tile builds into
BLOCK_SOURCES = {"legendre": "legendre", "disco": "disco_band",
                 "disco_bwd": "disco_band_bwd", "crps": "crps", "ssd": "ssd"}

#: the committed kernels' tiles, named after their CUDA constants (the
#: ``#define TUNE_<NAME>`` defaults in ``csrc/``): an absent or empty
#: ``BlockConfig`` launches exactly the committed library
BLOCK_DEFAULTS = {
    "legendre": {"STAGES": 2, "TB": 32, "TK": 16, "TN": 64},
    "disco": {"CH": 128, "MIN_BLOCKS": 2, "STAGES": 3, "TBP": 16},
    "disco_bwd": {"CH": 64, "MIN_BLOCKS": 3, "STAGES": 3},
    "crps": {"THREADS": 256},
    "ssd": {"HEADS_PER_BLOCK": 24, "THREADS": 512},
}


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """Tile override for one kernel family.

    ``dims`` is a sorted tuple of ``(name, value)`` pairs overriding a
    subset of ``BLOCK_DEFAULTS[op]``; unnamed dims keep their default.
    Frozen and hashable, so it nests in ``KernelConfig`` and therefore in
    every engine key: a tuned tile is another library.
    """

    op: str
    dims: tuple = ()

    def __post_init__(self):
        if self.op not in BLOCK_OPS:
            raise ValueError(f"BlockConfig.op must be one of {BLOCK_OPS}, "
                             f"got {self.op!r}")
        norm = []
        for name, value in self.dims:
            if name not in BLOCK_DEFAULTS[self.op]:
                raise ValueError(
                    f"unknown block dim {name!r} for op {self.op!r}; "
                    f"expected a subset of {sorted(BLOCK_DEFAULTS[self.op])}")
            if isinstance(value, bool) or not isinstance(value, int) \
                    or value < 1:
                raise ValueError(
                    f"block dim {name}={value!r} must be a positive int")
            norm.append((name, value))
        norm.sort()
        if len({n for n, _ in norm}) != len(norm):
            raise ValueError(f"duplicate block dims in {self.dims!r}")
        object.__setattr__(self, "dims", tuple(norm))

    @classmethod
    def make(cls, op: str, **dims: int) -> "BlockConfig":
        """``BlockConfig(op, sorted(dims.items()))``."""
        return cls(op, tuple(sorted(dims.items())))

    def sizes(self) -> dict:
        """Every dim's value: the defaults overlaid with this config."""
        return {**BLOCK_DEFAULTS[self.op], **dict(self.dims)}

    def is_default(self) -> bool:
        """Whether this is the committed tile."""
        return self.sizes() == BLOCK_DEFAULTS[self.op]

    def defines(self) -> tuple[tuple[str, int], ...]:
        """The ``-DTUNE_<NAME>=<v>`` pairs of the dims that differ from
        the committed tile (none for the committed tile itself)."""
        default = BLOCK_DEFAULTS[self.op]
        return tuple((f"TUNE_{name}", value) for name, value in self.dims
                     if value != default[name])


def block_sizes(op: str, blocks: "BlockConfig | None" = None) -> dict:
    """The tile a wrapper of ``op`` launches: ``BLOCK_DEFAULTS[op]`` for
    ``None``; a ``BlockConfig`` must carry the same ``op``."""
    if op not in BLOCK_OPS:
        raise ValueError(f"unknown block op {op!r}; expected {BLOCK_OPS}")
    if blocks is None:
        return dict(BLOCK_DEFAULTS[op])
    if blocks.op != op:
        raise ValueError(f"BlockConfig for op {blocks.op!r} passed to a "
                         f"{op!r} kernel")
    return blocks.sizes()


def library_of(op: str, blocks: "BlockConfig | None" = None
               ) -> tuple[str, tuple]:
    """``(source, defines)``: the ``kernels.build`` library that launches
    ``op`` with ``blocks`` (``None``: the committed one)."""
    block_sizes(op, blocks)   # validates op and blocks.op
    return BLOCK_SOURCES[op], blocks.defines() if blocks is not None else ()


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Per-op path selection; frozen and hashable so it nests in configs.

    sht / disco / ssd: "reference" | "kernel".  ``ssd`` comes after the
    two FCN3 ops, so ``KernelConfig(sht, disco)`` keeps its meaning.

    blocks: tile overrides, a tuple of ``BlockConfig`` (at most one per
    family, sorted by op).  Empty launches the committed kernels.  Filled
    by ``kernels.autotune.resolve_kernel_config`` from the installed
    tuning cache, or explicitly; threaded to every wrapper the paths
    above launch.
    """

    sht: str = "kernel"
    disco: str = "kernel"
    ssd: str = "kernel"
    blocks: tuple = ()

    def __post_init__(self):
        for op in OPS:
            if getattr(self, op) not in MODES:
                raise ValueError(f"KernelConfig.{op} must be one of {MODES}, "
                                 f"got {getattr(self, op)!r}")
        blocks = tuple(self.blocks)
        for bc in blocks:
            if not isinstance(bc, BlockConfig):
                raise ValueError(f"KernelConfig.blocks entries must be "
                                 f"BlockConfig, got {bc!r}")
        ops = [bc.op for bc in blocks]
        if len(set(ops)) != len(ops):
            raise ValueError(f"duplicate BlockConfig ops in {ops}")
        object.__setattr__(self, "blocks",
                           tuple(sorted(blocks, key=lambda b: b.op)))

    def blocks_for(self, op: str) -> BlockConfig | None:
        """This config's tile override for ``op`` (None: the committed
        tile)."""
        if op not in BLOCK_OPS:
            raise ValueError(f"unknown block op {op!r}; expected "
                             f"{BLOCK_OPS}")
        return next((bc for bc in self.blocks if bc.op == op), None)
