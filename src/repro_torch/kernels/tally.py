"""What the kernels and the collectives cost where nothing is launched: the
dry run's record (``launch/dryrun.py``).

A kernel wrapper that is handed a ``FakeTensor`` (torch's
``torch._subclasses.fake_tensor``: a shape, a dtype and a device, no
data) launches nothing and runs no plain version.  It notes the call here
-- its family, a key of its operands' shapes, the FLOPs and bytes of the
kernel's own formula (each family's ``work`` in its ``ops.py``) -- and
returns an empty fake output of the kernel's shape.  ``compat``'s
collectives note their output bytes here on fake tensors too.  A real
tensor never reaches this module: on it the wrappers launch or run their
plain versions as always.

The kernels skip their tables' zeros, so their FLOPs are what the data
needs: the non-zeros of a Legendre table or a DISCO band (``nnz``).  A
fake tensor holds no values; the count is taken where the table is made
from host data and carried with it (``launch/counting.py`` notes it on
the fake copy of a real tensor, and on every view or copy that keeps all
its elements).  There is no dense fallback: a fake table without a count
is refused.
"""

from __future__ import annotations

import collections

import torch

#: GPUs a node of the H100 model holds (``launch/roofline.py``): a
#: collective whose group has ranks on more than one node crosses the
#: node-to-node links
NODE_GPUS = 8
#: the attribute that carries a tensor's count of non-zero entries
NNZ_ATTR = "_repro_nnz"

#: kernel calls since the last ``take``: (family, key) -> [calls, FLOPs,
#: bytes]
calls: dict = {}
#: collective output bytes since the last ``take``: (kind, group size,
#: nodes its ranks span) -> [calls, bytes]
collectives: dict = {}


def is_fake(*tensors) -> bool:
    """Whether any of ``tensors`` is a ``FakeTensor``."""
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in tensors)


def note_nnz(t: torch.Tensor, n: int) -> None:
    """Attach the count of non-zero entries ``n`` to ``t``."""
    setattr(t, NNZ_ATTR, int(n))


def nnz(t: torch.Tensor) -> int:
    """The non-zero entries of ``t``: its carried count, or its base's
    where ``t`` is a view of all of its base's elements (a transposed
    table), or, on a real tensor, counted (and kept on it)."""
    for c in (t, t._base):
        if c is not None and getattr(c, NNZ_ATTR, None) is not None and (
                c is t or c.numel() == t.numel()):
            return getattr(c, NNZ_ATTR)
    if is_fake(t):
        raise ValueError(
            f"a fake tensor {tuple(t.shape)} {t.dtype} reached a kernel "
            "without a count of its non-zeros: make it from host data "
            "inside the dry run (launch/counting.py), which carries it")
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        n = int(torch.count_nonzero(t))
    note_nnz(t, n)
    if t._base is not None and t._base.numel() == t.numel():
        note_nnz(t._base, n)
    return n


def note(family: str, key: tuple, work: dict) -> None:
    """One kernel call of ``family`` on operands ``key``, costing
    ``work`` (its ``"flops"`` and ``"bytes"``)."""
    ent = calls.setdefault((family, key), [0, 0.0, 0.0])
    ent[0] += 1
    ent[1] += work["flops"]
    ent[2] += work["bytes"]


def note_collective(kind: str, ranks, nbytes: int) -> None:
    """One collective of ``kind`` over the global ``ranks`` whose output
    is ``nbytes`` on this rank."""
    key = (kind, len(ranks), len({r // NODE_GPUS for r in ranks}))
    ent = collectives.setdefault(key, [0, 0])
    ent[0] += 1
    ent[1] += int(nbytes)


def take() -> tuple[dict, dict]:
    """The calls and collectives noted since the last ``take``; both
    records start again empty."""
    global calls, collectives
    out = calls, collectives
    calls, collectives = {}, {}
    return out


def by_family(recorded: dict) -> dict[str, dict]:
    """``calls`` summed per family: calls, FLOPs and bytes."""
    out: dict = collections.defaultdict(
        lambda: {"calls": 0, "flops": 0.0, "bytes": 0.0})
    for (family, _), (n, f, b) in recorded.items():
        ent = out[family]
        ent["calls"] += n
        ent["flops"] += f
        ent["bytes"] += b
    return dict(out)
