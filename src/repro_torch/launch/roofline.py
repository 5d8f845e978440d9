"""Roofline terms of one step on an H100, from a dry run's counts.

Hardware model: one NVIDIA H100 SXM5 80GB per rank, its peaks from
NVIDIA's H100 data sheet:

* fp32 outside the tensor cores (SIMT): 67e12 FLOP/s;
* dense TF32 on the tensor cores: 495e12 FLOP/s.  The port's fp32
  products hold the fp32 bar as 3xTF32 (three TF32 products each,
  ``csrc/tf32x3.cuh``), so a FLOP of the step costs 3 / 495e12 s at
  best (``PEAK_FLOPS`` = 165e12): ``t_compute``.  ``t_compute_fp32`` is
  the same FLOPs at the SIMT rate;
* HBM3: 3.35e12 B/s;
* the collective links: 8 GPUs a node (``kernels.tally.NODE_GPUS``) on
  NVLink 4 (NVSwitch), 450e9 B/s a direction a GPU; between nodes one
  400 Gb/s NDR InfiniBand link a GPU, 50e9 B/s.  A collective whose
  group holds ranks of more than one node moves at the node-to-node
  rate.

Terms (seconds per step, per rank)::

  compute    = FLOPs / PEAK_FLOPS
  memory     = bytes / HBM_BW
  collective = sum over collectives of output bytes / their link's rate

The counts come from ``launch.counting.DryRun`` (the JAX package reads
XLA's cost analysis of a compiled module instead): FLOPs are the
kernels' own formulas plus ``FlopCounterMode`` over the aten ops, bytes
each op's inputs and outputs as the eager step moves them (XLA counts
after fusion), collective bytes the output bytes ``compat`` notes per
kind (there is no HLO to parse), and the memory term's peak is the live
set's (in place of ``memory_analysis``).

``bound`` is one kernel call's least time, as ``chip_smoke.py`` reports
it beside each kernel's measured time.
"""

from __future__ import annotations

import dataclasses

#: H100 SXM5 peaks (NVIDIA data sheet): fp32 SIMT, dense TF32 and HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
HBM_BW = 3.35e12
#: the fp32 products' best rate at the fp32 bar: 3xTF32
PEAK_FLOPS = PEAK_TF32_FLOPS / 3
#: NVLink 4 within a node (a direction, a GPU) and NDR InfiniBand between
#: nodes (one 400 Gb/s link a GPU)
NVLINK_BW = 450e9
IB_BW = 50e9
#: the JAX model's one link rate, here the rate within a node
ICI_BW = NVLINK_BW


@dataclasses.dataclass
class Roofline:
    """The JAX ``Roofline``'s fields and terms, on the H100 model."""

    name: str
    chips: int
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    coll_breakdown: dict[str, int]
    peak_memory_per_device: float        # the live set's peak
    model_flops: float                   # analytic (global)
    #: collective output bytes by rate: within a node, between nodes
    coll_nvlink_bytes: float = 0.0
    coll_ib_bytes: float = 0.0

    @property
    def t_compute(self) -> float:
        """FLOPs as 3xTF32 products on the tensor cores."""
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_compute_fp32(self) -> float:
        """The same FLOPs at the fp32 SIMT rate."""
        return self.flops_per_device / PEAK_FP32_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return (self.coll_nvlink_bytes / NVLINK_BW
                + self.coll_ib_bytes / IB_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def step_time_bound(self) -> float:
        """Lower bound on step time = max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu_bound(self) -> float:
        """Model-FLOP utilization upper bound at the roofline step time."""
        denom = self.step_time_bound * PEAK_FLOPS * self.chips
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "name": self.name, "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
            "peak_memory_per_device": self.peak_memory_per_device,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_compute_fp32_s": self.t_compute_fp32,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flop_ratio": self.useful_flop_ratio,
            "step_time_bound_s": self.step_time_bound,
            "mfu_bound": self.mfu_bound,
        }


def from_counts(name: str, counts, chips: int, model_flops: float
                ) -> Roofline:
    """The roofline of one rank's ``launch.counting.Counts``: collective
    bytes per kind as ``compat`` counted them (the JAX
    ``collective_bytes`` parses them from HLO text), each at the rate of
    the links its group spans."""
    coll = counts.collective_bytes()
    nv = sum(b for (_, _, nodes), (_, b) in counts.collectives.items()
             if nodes <= 1)
    ib = sum(b for (_, _, nodes), (_, b) in counts.collectives.items()
             if nodes > 1)
    return Roofline(
        name=name, chips=chips,
        flops_per_device=counts.kernel_flops + counts.aten_flops,
        hbm_bytes_per_device=counts.kernel_bytes + counts.aten_bytes,
        collective_bytes_per_device=float(sum(coll.values())),
        coll_breakdown=coll, peak_memory_per_device=float(counts.peak_bytes),
        model_flops=model_flops, coll_nvlink_bytes=float(nv),
        coll_ib_bytes=float(ib))


def analyze(name: str, step, args: tuple, chips: int, model_flops: float,
            dry) -> tuple[Roofline, object]:
    """Run ``step(*args)`` once on fake ``args`` inside the open
    ``launch.counting.DryRun`` ``dry`` and read its counts against the
    H100; returns the roofline and the counts."""
    dry.start()
    try:
        step(*args)
    finally:
        counts = dry.stop()
    return from_counts(name, counts, chips, model_flops), counts


def bound(flops: float, nbytes: float) -> dict:
    """Least time of one kernel call on the card: the larger of
    operations and bytes, with the operations at the fp32 rate
    (``bound_ms``) and as 3xTF32 products on the tensor cores
    (``bound_tc_ms``)."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / HBM_BW
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_tc_ms": 1e3 * max(3 * flops / PEAK_TF32_FLOPS, t_bytes)}


def model_flops_train(n_params_active: float, n_tokens: float) -> float:
    """6 N D rule (fwd 2ND + bwd 4ND)."""
    return 6.0 * n_params_active * n_tokens


def model_flops_decode(n_params_active: float, n_tokens: float) -> float:
    """Forward-only: 2 N D."""
    return 2.0 * n_params_active * n_tokens
