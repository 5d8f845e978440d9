"""Device choice and numeric precision: the one place the port sets both.

Entry points run on ``cuda`` unless the caller asks for ``"cpu"``; a
CUDA request on a machine without a usable card raises instead of
carrying on on the CPU.

fp32 matrix products run at "highest" precision and TF32 is off for
both cuBLAS and cuDNN, so the port computes what the fp32 JAX
reference computes (the card would otherwise run fp32 convolutions in
TF32, about three decimal digits).

``ProductDtypes`` shows which dtypes the products of a run take (the bf16
policy widens every one of them to fp32).
"""

from __future__ import annotations

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PRODUCT_OPS = ("mm", "bmm", "addmm", "baddbmm", "einsum")


def set_precision() -> None:
    """Full fp32 for matmul and cuDNN (no TF32 anywhere)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises ``RuntimeError`` for a CUDA device when no card is usable.
    Also applies the precision policy, so every entry point that picks
    its device gets the same numerics.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (--device cpu) to run on the CPU")
    set_precision()
    return dev


class ProductDtypes(TorchDispatchMode):
    """Counts the matrix products dispatched while it is active, by op and
    operand dtypes::

        with ProductDtypes() as seen:
            step()
        seen.counts    # {("einsum", "float32xfloat32"): 12, ...}

    Under inference mode ``einsum`` reaches the mode undecomposed, its
    operands in a list.
    """

    def __init__(self):
        super().__init__()
        self.counts: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in PRODUCT_OPS:
            ops = [a for x in args
                   for a in (x if isinstance(x, (list, tuple)) else [x])
                   if isinstance(a, torch.Tensor)]
            self.counts[(name, "x".join(str(a.dtype).split(".")[-1]
                                        for a in ops))] += 1
        return func(*args, **(kwargs or {}))
