#!/usr/bin/env python3
"""Time variants of the SSD kernels at the mamba2-130m prefill shape.

    python3 tools/ssd_variants.py [VARIANT ...] [--plain] [--parent PATH]

Needs one CUDA card and nvcc.  Times the committed intra-chunk kernel
(``src/repro_torch/csrc/ssd.cu``) and each VARIANT, a copy of it with a
constant replaced or a part of its work cut out, built in parallel into
``build/ssd_variants/`` and called through the same C entry point, on the
operands of one prefill layer (x 512 x 128 x 24 x 64, B and C 512 x 128
x 1 x 128, a chunk's |dA| sum around 13): ``heads12``, ``heads8`` and
``heads6`` take that many heads a block (24 committed), ``threads768``
gives the state product 16 warps of two n-tiles each (8 of four
committed); ``no_y`` (no att @ X), ``no_state`` (no state product),
``no_exp`` (the decays' exp left out) and ``no_stage`` (no copies of X
after the first two heads) give wrong results and time what is left.
With no VARIANT names, all of them run.  ``--parent PATH`` also builds
another ``ssd.cu`` (say the parent commit's, unpacked under the
git-ignored ``build/``) and times it in turns with the committed one
(parent, committed, committed, parent).  Then the inter-chunk recurrence
kernel (``csrc/ssd_state.cu``) runs on the states of that layer against
its plain loop.  Each line gives the median of 10 calls after one
warm-up (CUDA events); ``--plain`` holds each intra-chunk kernel to the
plain version (max |diff| over max |plain|).  Prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import PEAK_BYTES, bound, card_line, cuda_ms  # noqa: E402

#: one prefill layer of mamba2-130m at prefill_32k, batch 2
BC, L, H, P, G, N = 512, 128, 24, 64, 1, 128
#: name -> (text, replacement) pairs applied to ssd.cu
VARIANTS = {
    **{f"heads{n}": [("#define TUNE_HEADS_PER_BLOCK 24",
                      f"#define TUNE_HEADS_PER_BLOCK {n}")]
       for n in (12, 8, 6)},
    "threads768": [("#define TUNE_THREADS 512",
                    "#define TUNE_THREADS 768")],
    "no_y": [("    if (pb >= P) return;", "    if (pb >= P || L > 0) return;")],
    "no_state": [("    if (pb >= P || nb >= N) return;",
                  "    if (pb >= P || nb >= N || L > 0) return;")],
    "no_exp": [("__expf(", "(")],
    "no_stage": [("        if (j + 2 < nh) stage_head(",
                  "        if (j + 2 < nh && L < 0) stage_head(")],
}


def build_sources(sources: dict) -> dict:
    """Compile each name -> ssd.cu text in parallel; their C entry points."""
    from repro_torch.kernels import build
    out_dir = ROOT / "build" / "ssd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text.replace('#include "tf32x3.cuh"',
                                   f'#include "{build.CSRC}/tf32x3.cuh"'))
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        for ln in log.splitlines():
            if re.search(r"registers|spill", ln):
                print(f"[ptxas] {name}: {ln.strip()}", flush=True)
        fn = ctypes.CDLL(str(lib)).ssd_intra_chunk_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*",
                    help=f"variants to time, of {', '.join(VARIANTS)} "
                         f"(default: all)")
    ap.add_argument("--plain", action="store_true",
                    help="hold each to the plain version")
    ap.add_argument("--parent", type=Path,
                    help="another ssd.cu to time beside the committed one")
    args = ap.parse_args()
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"no variant {', '.join(sorted(unknown))}")
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import (chunk_recurrence_ref,
                                             ssd_intra_chunk_ref)
    from repro_torch.runtime import set_precision
    set_precision()
    print(card_line(), flush=True)
    t0 = time.time()
    committed = (build.CSRC / "ssd.cu").read_text()
    sources = {"committed": committed}
    for name in args.variants or list(VARIANTS):
        text = committed
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"{name}: ssd.cu has no {old!r}")
            text = text.replace(old, new)
        sources[name] = text
    if args.parent:
        sources["parent"] = args.parent.read_text()
    fns = build_sources(sources)
    print(f"[build] {len(fns)} libraries in {time.time() - t0:.1f}s",
          flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((BC, L, H, P), generator=gen, device="cuda")
    da = -torch.rand((BC, L, H), generator=gen, device="cuda") * 0.2
    da_cs = torch.cumsum(da, dim=1)
    b = torch.randn((BC, L, G, N), generator=gen, device="cuda")
    c = torch.randn((BC, L, G, N), generator=gen, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    taps = L * (L + 1) // 2
    flops = 2.0 * BC * (G * taps * N + H * taps * P + H * L * P * N)
    nbytes = 4.0 * (2 * x.numel() + da_cs.numel() + 2 * b.numel()
                    + BC * H * P * N)
    bd = bound(flops, nbytes)
    print(f"[ssd] x{tuple(x.shape)} B,C{tuple(b.shape)}: "
          f"bound_ms={bd['bound_ms']:.3f} ({bd['bound_by']}) "
          f"bound_tc_ms={bd['bound_tc_ms']:.3f}", flush=True)
    ref = ssd_intra_chunk_ref(x, da_cs, b, c) if args.plain else None

    def run(name):
        y = torch.empty((BC, L, H, P), device="cuda")
        st = torch.empty((BC, H, P, N), device="cuda")

        def call():
            if fns[name](x.data_ptr(), da_cs.data_ptr(), b.data_ptr(),
                         c.data_ptr(), y.data_ptr(), st.data_ptr(), BC, L,
                         H, P, G, N, stream):
                raise RuntimeError(f"{name}: launch failed")
        call()
        torch.cuda.synchronize()
        line = f"[ssd] {name}: ms={cuda_ms(call, reps=10):.3f}"
        if ref is not None:
            errs = [float((got - want).abs().max() / want.abs().max())
                    for got, want in zip((y, st), ref)]
            line += f" rel_err y={errs[0]:.2e} states={errs[1]:.2e}"
        print(line, flush=True)

    order = [n for n in fns if n != "parent"]
    if args.parent:
        order = ["parent", "committed", *order, "parent"]
    for name in order:
        run(name)

    # the recurrence over the 256 chunks of each of 2 sequences
    _, st = ops.ssd_intra_chunk(x, da_cs, b, c)
    states = st.reshape(2, BC // 2, H, P, N)
    decay = torch.exp(da_cs[:, -1, :]).reshape(2, BC // 2, H).contiguous()
    init = torch.randn((2, H, P, N), generator=gen, device="cuda")
    kernel_ms = cuda_ms(lambda: ops.chunk_recurrence(states, decay, init),
                        reps=10)
    plain_ms = cuda_ms(lambda: chunk_recurrence_ref(states, decay, init),
                       reps=3)
    sbytes = 4.0 * (2 * states.numel() + decay.numel() + 2 * init.numel())
    got = ops.chunk_recurrence(states, decay, init)
    want = chunk_recurrence_ref(states, decay, init)
    err = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(got, want))
    print(f"[ssd_state] states{tuple(states.shape)}: ms={kernel_ms:.3f} "
          f"plain_ms={plain_ms:.3f} bound_ms={1e3 * sbytes / PEAK_BYTES:.3f} "
          f"(bytes) GB/s={sbytes / kernel_ms / 1e6:.0f} rel_err={err:.2e}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
