#!/usr/bin/env python3
"""Time variants of the SSD kernels (with --bwd: of the intra-chunk backward).

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

    python3 tools/ssd_variants.py --bwd [VARIANT ...] [--plain] [--parent PATH]

The backward mode times the intra-chunk backward (``csrc/ssd_bwd.cu``)
at ``[lm-train]``'s shape (x 256 x 128 x 24 x 64, B and C 256 x 128 x 1
x 128) and at zamba2-2.7b's 80 heads (x 256 x 128 x 80 x 64, N 64): the
committed kernel whole, then each of its launches alone (``launch:K``,
a copy whose other launches are left out: the split of its time), then
each VARIANT of ``BWD_VARIANTS`` (other head tiles, ablations).  With
``--parent PATH`` (another ``ssd_bwd.cu``, say the parent commit's) the
parent is timed in turns with the committed kernel (parent, committed,
committed, parent) and split into its launches too; it must have the
committed one's C interface (one scratch of ``ssd_bwd_scratch``
floats).  ``--plain`` holds each whole kernel to float64 autograd of the
plain version (the largest excess over rtol 2e-3; the bar is atol 2e-4).
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

from chip_smoke import bound, card_line, cuda_ms  # noqa: E402
from repro_torch.launch.roofline import HBM_BW as PEAK_BYTES  # noqa: E402

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


def build_sources(sources: dict, subdir: str = "ssd_variants") -> dict:
    """Compile each name -> CUDA source text in parallel; their libraries
    (ctypes.CDLL)."""
    from repro_torch.kernels import build
    out_dir = ROOT / "build" / subdir
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        stem = re.sub(r"[^A-Za-z0-9_]", "_", name)
        cu = out_dir / f"{stem}.cu"
        cu.write_text(text.replace('#include "tf32x3.cuh"',
                                   f'#include "{build.CSRC}/tf32x3.cuh"'))
        lib = out_dir / f"lib{stem}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        for ln in log.splitlines():
            if re.search(r"registers|spill", ln):
                print(f"[ptxas] {name}: {ln.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def forward_fn(lib):
    fn = lib.ssd_intra_chunk_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


#: the backward mode's shapes, (BC, L, H, P, G, N): [lm-train]'s layer
#: (8 sequences of 4096) and zamba2-2.7b's 80 heads at 1 x 32768
BWD_SHAPES = {"train": (256, 128, 24, 64, 1, 128),
              "zamba2-80-heads": (256, 128, 80, 64, 1, 64)}
#: name -> (text, replacement) pairs applied to ssd_bwd.cu: other head
#: tiles (24 committed; the warps are pinned at 16 by the registers that Z
#: and dCB hold a whole tile of heads); ablations that give wrong results
#: and time what is left: no_z (no (w X) dst), no_dx (no dX), no_datt (no
#: datt^T, dCB, M), no_stage (no copies after the first head); rz (each
#: mma accumulates into the running tile, as the forward's do: the cost of
#: the extra add, and its rounding toward zero)
BWD_VARIANTS = {
    **{f"heads{n}": [("constexpr int HEADS_PER_BLOCK = 24;",
                      f"constexpr int HEADS_PER_BLOCK = {n};")]
       for n in (16, 12, 8)},
    **{f"no_{part}": [(f"        head_{part}(p, ", f"        if (p.L < 0) "
                                                  f"head_{part}(p, ")]
       for part in ("z", "dx", "datt")},
    "no_stage": [("        stage_lp(p, dys, p.dy, bc, h);",
                  "        if (jh == 0) stage_lp(p, dys, p.dy, bc, h);"),
                 ("        if (jh + 1 < nh) stage_dst(",
                  "        if (jh + 1 < nh && p.L < 0) stage_dst("),
                 ("        if (jh + 1 < nh) {\n            stage_lp(",
                  "        if (jh + 1 < nh && p.L < 0) {\n            "
                  "stage_lp(")],
    "rz": [("    float d[4] = {0.f, 0.f, 0.f, 0.f};",
            "    float (&d)[4] = c;"),
           ("    for (int e = 0; e < 4; ++e) c[e] += d[e];",
            "    for (int e = 0; e < 0; ++e) c[e] += d[e];")],
}
_LAUNCH = re.compile(r"^(\s*)(\w+)<<<", re.M)


def launch_split(text: str) -> dict:
    """``launch:K`` -> a copy of a backward source whose launches other
    than kernel K's are left out (``if (0)``), one per launch."""
    names = [m.group(2) for m in _LAUNCH.finditer(text)]
    out = {}
    for keep in names:
        out[f"launch:{keep}"] = _LAUNCH.sub(
            lambda m: m.group(0) if m.group(2) == keep
            else f"{m.group(1)}if (0) {m.group(2)}<<<", text)
    return out


def backward_call(lib, shape, ins, cots, stream):
    """A callable that runs one backward library on the operands, with a
    scratch of ``ssd_bwd_scratch`` floats; and its outputs."""
    import torch
    bc, l, h, p, g, n = shape
    fn = lib.ssd_bwd_launch
    outs = [torch.empty_like(t) for t in ins]
    sizer = lib.ssd_bwd_scratch
    sizer.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 2
    sizer.restype = ctypes.c_longlong
    scratch = torch.empty((max(int(sizer(bc, h, g)), 1),), device="cuda")
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ptrs = [t.data_ptr() for t in (*ins, *cots, *outs, scratch)]

    def call():
        err = fn(*ptrs, bc, l, h, p, g, n, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call, outs


def backward_mode(args) -> int:
    """The --bwd mode: see the module docstring."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref
    t0 = time.time()
    committed = (build.CSRC / "ssd_bwd.cu").read_text()
    sources = {"committed": committed, **launch_split(committed)}
    for name in args.variants or list(BWD_VARIANTS):
        text = committed
        for old, new in BWD_VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"{name}: ssd_bwd.cu has no {old!r}")
            text = text.replace(old, new)
        sources[name] = text
    if args.parent:
        parent = args.parent.read_text()
        sources["parent"] = parent
        sources.update({f"parent/{k}": v
                        for k, v in launch_split(parent).items()})
    libs = build_sources(sources, "ssd_bwd_variants")
    print(f"[build] {len(libs)} libraries in {time.time() - t0:.1f}s",
          flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    for tag, shape in BWD_SHAPES.items():
        bc, l, h, p, g, n = shape
        gen = torch.Generator(device="cuda").manual_seed(0)

        def randn(*s):
            return torch.randn(s, generator=gen, device="cuda")
        da = -randn(bc, l, h).abs() * 0.1
        ins = (randn(bc, l, h, p), torch.cumsum(da, dim=1),
               randn(bc, l, g, n), randn(bc, l, g, n))
        cots = (randn(bc, l, h, p), randn(bc, h, p, n))
        w = ops.bwd_work((bc, l, h, p), g, n)
        bd = bound(w["flops"], w["bytes"])
        print(f"[ssd_bwd] {tag} x{tuple(ins[0].shape)} "
              f"B,C{tuple(ins[2].shape)}: bound_ms={bd['bound_ms']:.3f} "
              f"({bd['bound_by']}) bound_tc_ms={bd['bound_tc_ms']:.3f}",
              flush=True)
        want = None
        if args.plain:
            ts = [t.detach().double().requires_grad_(True) for t in ins]
            want = torch.autograd.grad(ssd_intra_chunk_ref(*ts), ts,
                                       [c.double() for c in cots])
        whole = ["committed", *(k for k in BWD_VARIANTS if k in sources)]
        if args.parent:
            whole = ["parent", "committed", "committed", "parent",
                     *whole[1:]]
        order = whole + [k for k in sources if ":" in k]
        for name in order:
            call, outs = backward_call(libs[name], shape, ins, cots, stream)
            call()
            torch.cuda.synchronize()
            ms = cuda_ms(call, reps=10)
            line = (f"[ssd_bwd] {tag} {name}: ms={ms:.3f} "
                    f"ms/bound_ms={ms / bd['bound_ms']:.2f}")
            if want is not None and ":" not in name:
                excess = max(float(((a.double() - r).abs()
                                    - 2e-3 * r.abs()).max())
                             for a, r in zip(outs, want))
                line += f" excess_over_rtol={excess:.3e} (bar 2e-4)"
            print(line, flush=True)
            del call, outs
        del ins, cots, want
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*",
                    help=f"variants to time, of {', '.join(VARIANTS)} "
                         f"(default: all)")
    ap.add_argument("--plain", action="store_true",
                    help="hold each to the plain version")
    ap.add_argument("--parent", type=Path,
                    help="another ssd.cu (ssd_bwd.cu with --bwd) to time "
                         "beside the committed one")
    ap.add_argument("--bwd", action="store_true",
                    help="time the intra-chunk backward (ssd_bwd.cu)")
    args = ap.parse_args()
    unknown = set(args.variants) - set(BWD_VARIANTS if args.bwd
                                       else VARIANTS)
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
    if args.bwd:
        return backward_mode(args)
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
    fns = {k: forward_fn(v) for k, v in build_sources(sources).items()}
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
