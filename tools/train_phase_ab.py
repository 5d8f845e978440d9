#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s fcn3_full training phase alone in several trees.

    python3 tools/train_phase_ab.py TREE[:keep] [TREE[:keep] ...]

Needs one CUDA card and nvcc.  Each TREE is a checkout of the repo (say
the parent commit and this one, unpacked with ``git archive`` under the
git-ignored ``build/``); each argument runs in a fresh process, in the
order given (parent, change, change, parent compares two trees on one
card).  The process builds the tree's kernels, then calls that tree's
``chip_smoke.train_phase``; ``:keep`` passes it a temporary directory as
``keep`` (the initial checkpoint and the first step taken again after
the timed steps).  Prints the card's name and power limit, then one line
per run: the tree, the mode, each step's seconds, the phase's peak
device memory (``max_memory_allocated``, GB) and its set-up seconds.
"""

from __future__ import annotations

import subprocess
import sys

RUN = """
import sys, tempfile, time
sys.path.insert(0, '.')
import chip_smoke
from repro_torch.kernels import build
build.build_all()
kw = {'keep': tempfile.mkdtemp()} if sys.argv[1] == 'keep' else {}
s = chip_smoke.train_phase(lambda line: None, **kw)
print([round(x, 3) for x in s['step_s']], round(s['peak_mem_gb'], 4),
      round(s['setup_s'], 1))
"""


def main(argv: list[str]) -> int:
    """Run every argument in turn; 1 if one fails."""
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for arg in argv:
        tree, _, mode = arg.partition(":")
        out = subprocess.run([sys.executable, "-c", RUN, mode or "none"],
                             cwd=tree, capture_output=True, text=True)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
        steps, peak, setup = out.stdout.strip().splitlines()[-1].rsplit(
            " ", 2)
        print(f"tree={tree} mode={mode or 'none'} step_s={steps} "
              f"peak_mem_gb={peak} setup_s={setup}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
