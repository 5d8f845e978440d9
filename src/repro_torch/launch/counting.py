"""The dry run's counting layer: one step on fake tensors, counted.

``DryRun`` opens a ``FakeTensorMode`` (torch's tensors with a shape, a
dtype and a device but no data) and a ``Counter`` over it.  Everything
made inside -- parameters, optimizer state, geometry buffers, inputs --
is fake; nothing is allocated on a device and nothing is launched.
Between ``start()`` and ``stop()`` it counts:

* the kernels' calls, FLOPs and bytes, by family and operand shapes: each
  wrapper's counting branch (``kernels.tally``), with the FLOPs the data
  needs (the tables' non-zeros, carried from the host data);
* the FLOPs of every other op: ``torch.utils.flop_counter.
  FlopCounterMode`` over the aten ops (a kernel call reaches none of
  them);
* bytes: each aten op's input and output bytes, views and empty
  factories left out (collectives are not aten ops).  This is the
  traffic of an eager step, the port's way of running; XLA's "bytes
  accessed" counts a program after fusion, so the two are not the same
  measure;
* the collectives' output bytes by kind and group (``compat`` notes them
  in ``kernels.tally``);
* the live set: every fake storage on the run's device, from its first
  op to its release, and its peak, split at the peak into what the
  caller labelled (``label``: parameters, optimizer, buffers, inputs,
  gradients) and the rest (activations).  A garbage collection runs
  before a new peak is taken (past a growth of ``_COLLECT_GROWTH``):
  some fake storages are released only by one.

Real host data that enters an op -- a plan's numpy table made a tensor
-- is made fake by the ``Counter``, which notes its count of non-zeros
on the fake copy (``kernels.tally.nnz``) and carries it through every
copy, cast and view that keeps all of its elements.

The step body must make no host read: a fake tensor has no values, so
``.item()``, ``float(t)`` and the like raise.  Without a usable card the
fake tensors stand on device ``cpu``: on a torch built without CUDA,
autograd on a fake CUDA tensor aborts the process (it asks the missing
CUDA device guard for a stream).  The counts do not depend on the device
(on an H100 cpu and cuda fakes gave the same calls and FLOPs, and aten
bytes within 0.1 %).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.kernels import tally

#: ops whose output holds every element of their first argument (a copy,
#: a cast, an alias): the output keeps its count of non-zeros
_KEEPS = frozenset(("_to_copy", "clone", "detach", "alias", "lift_fresh",
                    "lift_fresh_copy", "_unsafe_view"))
#: a new peak more than this share above the live set at the last
#: garbage collection is taken only after another one (``Counter.track``)
_COLLECT_GROWTH = 0.05
#: aten ops that move no data
_NO_BYTES = frozenset(("empty", "empty_strided", "empty_like", "new_empty",
                       "new_empty_strided", "detach", "alias", "lift_fresh",
                       "_unsafe_view", "set_", "resize_"))


def dry_run_device() -> torch.device:
    """Where a dry run's fake tensors stand: ``cuda`` with a card, else
    ``cpu`` (see the module docstring)."""
    return torch.device("cuda", 0) if torch.cuda.is_available() else \
        torch.device("cpu")


@dataclasses.dataclass
class _Storage:
    nbytes: int
    born: int
    died: float = float("inf")
    label: str | None = None


class Counter(TorchDispatchMode):
    """Counts every op dispatched over ``fake_mode``: aten bytes (while
    ``counting``), the non-zero counts of host data and the live set of
    fake storages on ``device``."""

    def __init__(self, fake_mode, device: torch.device):
        super().__init__()
        self.fake_mode, self.device = fake_mode, torch.device(device)
        self.counting = False
        self.aten_bytes = 0.0
        self.op_bytes: dict[str, float] = {}
        #: events (a storage made or released) so far: the live set's clock
        self.seq = 0
        self.live = 0
        self.peak = self.peak_seq = 0
        self._collected_at = 0
        self.records: list[_Storage] = []
        self._stores = torch.utils.weak.WeakIdKeyDictionary()

    # -- the live set -------------------------------------------------------
    def _free(self, rec: _Storage) -> None:
        self.seq += 1
        rec.died = self.seq
        self.live -= rec.nbytes

    def track(self, t) -> _Storage | None:
        """The record of ``t``'s storage, made at its first sight; only
        fake tensors on the run's device are tracked."""
        if not (isinstance(t, torch.Tensor) and tally.is_fake(t)
                and t.device.type == self.device.type):
            return None
        st = t.untyped_storage()
        rec = self._stores.get(st)
        if rec is None:
            self.seq += 1
            rec = _Storage(st.nbytes(), self.seq)
            self._stores[st] = rec
            self.records.append(rec)
            weakref.finalize(st, self._free, rec)
            self.live += rec.nbytes
            if (self.counting and self.live > self.peak and self.live
                    > self._collected_at * (1 + _COLLECT_GROWTH)):
                # some fake storages outlive their last use until a
                # collection (with checkpointed chunks in the backward: at
                # fcn3_small with the DISCO merge in 4 MB chunks the peak
                # doubles with the collector off, and with a collection
                # here it equals a real step's live set to the byte)
                gc.collect()
                self._collected_at = self.live
            if self.live > self.peak:
                self.peak, self.peak_seq = self.live, self.seq
        return rec

    def label(self, tree, name: str) -> None:
        """Label the storages of the tensors in ``tree`` as ``name``
        (where no earlier label holds)."""
        for t in tree_flatten(tree)[0]:
            rec = self.track(t)
            if rec is not None and rec.label is None:
                rec.label = name

    def reset_peak(self) -> None:
        """Start the peak again from the live set as it is now."""
        gc.collect()
        self.peak, self.peak_seq = self.live, self.seq
        self._collected_at = self.live

    def at_peak(self) -> dict[str, int]:
        """The bytes live at the peak, by label (``activations``: none)."""
        out: dict[str, int] = {}
        for rec in self.records:
            if rec.born <= self.peak_seq < rec.died:
                key = rec.label or "activations"
                out[key] = out.get(key, 0) + rec.nbytes
        return out

    # -- the ops -------------------------------------------------------------
    def _fake(self, a):
        """A real tensor as a fake one, its count of non-zeros noted."""
        if not isinstance(a, torch.Tensor) or tally.is_fake(a):
            return a
        f = self.fake_mode.from_tensor(a)
        if a.is_floating_point() and getattr(f, tally.NNZ_ATTR, None) is None:
            tally.note_nnz(f, tally.nnz(a))
        return f

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        args, kwargs = tree_map(self._fake, (args, kwargs or {}))
        out = func(*args, **kwargs)
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        for t in ins + outs:
            self.track(t)
        name = func.overloadpacket.__name__
        if ins and outs:
            src = ins[0]
            n = getattr(src, tally.NNZ_ATTR, None)
            if n is not None and (name in _KEEPS or (
                    func.is_view and outs[0].numel() == src.numel())):
                tally.note_nnz(outs[0], n)
            elif name == "copy_" and len(ins) > 1 and getattr(
                    ins[1], tally.NNZ_ATTR, None) is not None and (
                    ins[1].numel() == src.numel()):
                tally.note_nnz(src, getattr(ins[1], tally.NNZ_ATTR))
        if (self.counting and func.namespace == "aten" and not func.is_view
                and name not in _NO_BYTES):
            nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
            self.aten_bytes += nbytes
            self.op_bytes[name] = self.op_bytes.get(name, 0.0) + nbytes
        return out


@dataclasses.dataclass
class Counts:
    """What one counted step did on this rank."""

    kernels: dict          # family -> {"calls", "flops", "bytes"}
    kernel_calls: dict     # (family, operand key) -> [calls, FLOPs, bytes]
    aten_flops: float
    aten_bytes: float
    aten_op_bytes: dict    # aten op -> bytes
    collectives: dict      # (kind, group size, spans nodes) -> [calls, bytes]
    peak_bytes: int        # the live set's peak
    at_peak: dict          # its bytes by label

    @property
    def kernel_flops(self) -> float:
        """The kernels' FLOPs."""
        return sum(v["flops"] for v in self.kernels.values())

    @property
    def kernel_bytes(self) -> float:
        """The kernels' bytes."""
        return sum(v["bytes"] for v in self.kernels.values())

    def collective_bytes(self) -> dict[str, int]:
        """Output bytes by kind of collective."""
        out: dict[str, int] = {}
        for (kind, _, _), (_, b) in self.collectives.items():
            out[kind] = out.get(kind, 0) + b
        return out


class DryRun:
    """A ``FakeTensorMode`` and its ``Counter`` over ``device``::

        with DryRun() as dr:
            model = FCN3(cfg, device=dr.device)     # fake parameters
            ...                                      # fake buffers, inputs
            dr.label(params, "parameters")
            dr.start()
            step(...)
            counts = dr.stop()

    Construction inside the ``with`` is not counted, its live set is.
    """

    def __init__(self, device: str | torch.device | None = None):
        self.device = (dry_run_device() if device is None
                       else torch.device(device))
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", 0)
        self._stack = contextlib.ExitStack()
        self._flops = None

    def __enter__(self) -> "DryRun":
        from torch._subclasses.fake_tensor import FakeTensorMode
        self.fake_mode = self._stack.enter_context(
            FakeTensorMode(allow_non_fake_inputs=True))
        self.counter = self._stack.enter_context(
            Counter(self.fake_mode, self.device))
        tally.take()
        return self

    def __exit__(self, *exc) -> None:
        if self._flops is not None:
            self._flops.__exit__(*exc)
            self._flops = None
        self._stack.close()
        tally.take()

    def fake(self, tree):
        """``tree`` with every real tensor replaced by a fake copy on the
        run's device (its non-zeros counted), fakes kept."""
        def one(t):
            if isinstance(t, torch.Tensor) and not tally.is_fake(t):
                return t.to(self.device, copy=True)
            return t
        return tree_map(one, tree)

    def label(self, tree, name: str) -> None:
        """See ``Counter.label``."""
        self.counter.label(tree, name)

    def start(self) -> None:
        """Count from here: FLOPs, bytes, kernels, collectives, and the
        peak from the live set as it stands."""
        from torch.utils.flop_counter import FlopCounterMode
        tally.take()
        self.counter.aten_bytes = 0.0
        self.counter.op_bytes = {}
        self.counter.counting = True
        self.counter.reset_peak()
        # what exists now (the model, its plans, the fake mode) lives on:
        # the collections during the step need not scan it
        gc.freeze()
        self._flops = FlopCounterMode(display=False)
        self._flops.__enter__()

    def stop(self) -> Counts:
        """Stop counting; what was counted since ``start``."""
        self._flops.__exit__(None, None, None)
        gc.unfreeze()
        flops, self._flops = self._flops.get_total_flops(), None
        self.counter.counting = False
        calls, colls = tally.take()
        return Counts(kernels=tally.by_family(calls), kernel_calls=calls,
                      aten_flops=float(flops),
                      aten_bytes=self.counter.aten_bytes,
                      aten_op_bytes=dict(self.counter.op_bytes),
                      collectives=colls, peak_bytes=self.counter.peak,
                      at_peak=self.counter.at_peak())
