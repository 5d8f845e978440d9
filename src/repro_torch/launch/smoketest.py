"""The smoke version of the production dry run: every architecture's
train step on a (4, 2) fake mesh of 8 ranks, the counterpart of the JAX
package's ``launch/smoketest.py``.

For each name in ``configs.archs.ARCHS``, the smoke config's train step
(the loss, its backward, the gradients' all-reduce over the data ranks
and the Adam update, ``launch/dryrun.py``'s LM train case) at a global
batch of 8 x 64 tokens (``vlm``: 64 less its patches, with the patches;
``audio``: with the encoder frames) runs on fake tensors as rank 0 of a
fake world of 8 ranks, read through ``launch/roofline.py``.  Each must
count FLOPs a rank and a live-set peak above zero; one line each, then
``SMOKE DRYRUN PASSED``.  Needs no card::

  python -m repro_torch.launch.smoketest
"""

from __future__ import annotations

import sys

from repro_torch.configs import archs as archlib
from repro_torch.configs import shapes as shapelib
from repro_torch.launch import counting, dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import roofline as roof

MESH = (4, 2)
SHAPE = shapelib.InputShape("smoke_train", seq_len=64, global_batch=8,
                            mode="train")


def check_arch(name: str, mesh, device) -> roof.Roofline:
    """One architecture's smoke train step, counted; raises unless its
    FLOPs and its peak are positive."""
    cfg = archlib.smoke_config(name)
    with counting.DryRun(device) as dry:
        case = dryrun.build_lm_case(name, SHAPE, mesh, dry, cfg=cfg)
        rl, _ = roof.analyze(name, case.step, case.args, len(mesh.mesh),
                             case.model_flops, dry)
    assert rl.flops_per_device > 0, (name, rl.flops_per_device)
    assert rl.peak_memory_per_device > 0, (name, rl.peak_memory_per_device)
    print(f"{name}: compile ok, bottleneck={rl.bottleneck}, "
          f"coll={rl.collective_bytes_per_device / 1e6:.1f}MB", flush=True)
    return rl


def main() -> int:
    """Every architecture in turn in one fake world."""
    device = counting.dry_run_device()
    with dryrun.fake_world(MESH[0] * MESH[1]):
        mesh = meshlib.make_mesh(MESH, ("data", "model"), device.type)
        for name in sorted(archlib.ARCHS):
            check_arch(name, mesh, device)
    print("SMOKE DRYRUN PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
