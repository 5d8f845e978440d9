#!/usr/bin/env python3
"""Time variants of the band-transpose kernel at the fcn3_full shapes.

    python3 tools/disco_transpose_variants.py [--plain] [VARIANT ...]

Needs one CUDA card and nvcc.  Each variant is a copy of
``src/repro_torch/csrc/disco_band_bwd.cu`` with some of its tile
constants replaced, or with a part of its work cut out (``no_compute``
skips the products, ``no_stage`` skips the g windows' copies: both give
wrong results and time what is left).  All are built in parallel into
``build/transpose_variants/`` and called through the kernel's C entry
point on the same inputs, at the four shapes a ``fcn3_full`` training
step gives the transpose (latent g of 295 and 87 planes, decoder g of 56
and 45).  Prints each kernel's registers and spills as ptxas reports
them, then one line per shape: the fp32 bound, what the committed kernel
does there (units, staged bytes, mma count) and each variant's median
time (CUDA events, 5 calls after one warm-up), with ``--plain`` its
largest error relative to max |plain| (the plain version takes ~40 s for
the four shapes).  With no VARIANT names, all of them run.
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

from chip_smoke import card_line, cuda_ms  # noqa: E402

PEAK_FP32_FLOPS = 67e12     # H100 SXM, outside the tensor cores

NO_COMPUTE = [("            if (i >= NT + q.nd) break;",
               "            if (i >= NT + q.nd || p.K < 100) break;")]
NO_STAGE = [("    for (int j = k0; j < n; j += TPP) {",
             "    for (int j = k0; j < n && p.K > 100; j += TPP) {")]
TWO_BLOCKS = {"STAGES": "4", "MIN_BLOCKS": "2"}
#: name -> constants to replace and text to replace
VARIANTS = {
    "committed": {},
    "four_stages_two_blocks": {"const": TWO_BLOCKS},
    "five_stages_two_blocks": {"const": {"STAGES": "5", "MIN_BLOCKS": "2"}},
    "ch32": {"const": {"CH": "32"}},
    "ch48": {"const": {"CH": "48"}},
    "ch32_four_stages": {"const": {"CH": "32", "STAGES": "4"}},
    "threads128": {"const": {"THREADS": "128", "TV": "128", "CH": "32",
                             "MIN_BLOCKS": "6"}},
    "ch32_four_blocks": {"const": {"CH": "32", "MIN_BLOCKS": "4"}},
    "ch16_four_blocks": {"const": {"CH": "16", "MIN_BLOCKS": "4"}},
    "no_compute": {"text": NO_COMPUTE},
    "no_stage": {"text": NO_STAGE},
    "no_compute_no_stage": {"text": NO_COMPUTE + NO_STAGE},
    "no_compute_two_blocks": {"const": TWO_BLOCKS, "text": NO_COMPUTE},
    "no_stage_two_blocks": {"const": TWO_BLOCKS, "text": NO_STAGE},
}


def build_variants(names):
    """Compile the named variants in parallel; their C entry points."""
    from repro_torch.kernels import build
    src = (build.CSRC / "disco_band_bwd.cu").read_text().replace(
        '#include "tf32x3.cuh"', f'#include "{build.CSRC}/tf32x3.cuh"')
    out_dir = ROOT / "build" / "transpose_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name].get("text", []):
            if old not in text:
                raise SystemExit(f"{name}: the source has no {old!r}")
            text = text.replace(old, new)
        for const, value in VARIANTS[name].get("const", {}).items():
            # a tunable constant's default is a #define TUNE_<NAME>
            text, n = re.subn(rf"#define TUNE_{const} \d+",
                              f"#define TUNE_{const} {value}", text)
            if n != 1:
                text, n = re.subn(rf"constexpr int {const} = \d+;",
                                  f"constexpr int {const} = {value};", text)
            if n != 1:
                raise SystemExit(f"{name}: no constant {const}")
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        stride = "?"
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        for ln in log.splitlines():
            m = re.search(r"kernelILi(\d)E", ln)
            if m:
                stride = m.group(1)
            elif "registers" in ln or "spill stores" in ln:
                print(f"[ptxas] {name} stride {stride}: {ln.strip()}",
                      flush=True)
        fn = ctypes.CDLL(str(lib)).disco_band_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def work_counts(taps, w_in: int, stride: int, planes: int) -> dict:
    """What the committed kernel does at one shape, counted from the live
    taps: its (piece, basis) units, the bytes of g windows it stages
    (each window row with 2 floats for its alignment shift, which is 0..3)
    and its mma.sync products, three per 3xTF32 product, with the share
    of them that lands on the slices' spans."""
    import numpy as np
    from repro_torch.kernels.config import BLOCK_DEFAULTS
    # the committed kernel's TV (csrc/disco_band_bwd.cu) and CH
    tv, ch, k = 256, BLOCK_DEFAULTS["disco_bwd"]["CH"], 7
    padded = -(-taps["tap_ent"][:, 2] // 8) * 8
    pieces = np.concatenate([np.minimum(ch, p - np.arange(0, p, ch))
                             for p in padded])
    nd = (pieces + 9 * stride - 2) // (8 * stride)
    blocks = -(-w_in // tv) * -(-planes // 16)
    nt = 32 // (8 * stride)                     # n-tiles of a parity
    mma = 3 * 8 * stride * nt * (nd + 1).sum() * k * blocks
    live = 3 * 8 * stride * nt * (pieces / (8 * stride)).sum() * k * blocks
    return {"units": int(len(pieces) * k * blocks),
            "staged_gb": float(16 * 4 * (tv // stride + 8 * nd + 2).sum()
                               * k * blocks / 1e9),
            "mma": float(mma), "live_share": float(live / mma)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*",
                    help=f"variants to time, of {', '.join(VARIANTS)} "
                         f"(default: all)")
    ap.add_argument("--plain", action="store_true",
                    help="hold each variant to the plain version")
    args = ap.parse_args()
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"no variant {', '.join(sorted(unknown))}")
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import fcn3 as cfgs
    from repro_torch.core.sphere import disco, grids
    from repro_torch.kernels.disco import ops
    from repro_torch.kernels.disco.ref import disco_band_transpose_ref
    from repro_torch.runtime import set_precision
    set_precision()
    t0 = time.time()
    fns = build_variants(args.variants or list(VARIANTS))
    print(f"[build] {len(fns)} variants in {time.time() - t0:.1f}s",
          flush=True)
    print(card_line(), flush=True)
    cfg = cfgs.fcn3_full()
    g_in = grids.make_grid(cfg.nlat, cfg.nlon, cfg.grid)
    g_lat = grids.make_grid(cfg.latent_nlat, cfg.latent_nlon,
                            cfg.latent_grid)
    plans = {"latent": disco.make_disco_plan(
                 g_lat, g_lat, cfg.filter_ell_max, cfg.filter_m_max,
                 cfg.latent_cutoff),
             "decoder": disco.make_disco_plan(
                 g_in, g_in, cfg.filter_ell_max, cfg.filter_m_max,
                 cfg.encoder_cutoff)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for what, b in (("latent", 295), ("latent", 87), ("decoder", 56),
                    ("decoder", 45)):
        plan = plans[what]
        bufs = plan.banded_buffers("cuda")
        taps, rows = ops.LiveTaps.of(bufs), ops.RowTaps.of(bufs)
        psi = bufs["psi_band"]
        k, h_out, _, d = psi.shape
        h_in, w_in = plan.grid_in.nlat, plan.grid_in.nlon
        w_out = w_in // plan.stride
        g = torch.randn((b, k, h_out, w_out), generator=gen, device="cuda")
        flops = 2.0 * int((psi != 0).sum()) * w_out * b
        ref = (disco_band_transpose_ref(g, psi, bufs["lat_idx"], h_in,
                                        plan.stride) if args.plain else None)
        cells = []
        for name, fn in fns.items():
            def call(fn=fn):
                gx = torch.empty((b, h_in, w_in), device="cuda")
                err = fn(g.data_ptr(), rows.ptr.data_ptr(),
                         rows.ent.data_ptr(), rows.order.data_ptr(),
                         taps.ent.data_ptr(), taps.psi.data_ptr(),
                         gx.data_ptr(), b, k, h_out, w_out, h_in, d,
                         plan.stride, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
                return gx
            cell = f"{name}={cuda_ms(call, reps=5):.3f}ms"
            if ref is not None:
                got = call()
                rel = float((got - ref).abs().max() / ref.abs().max())
                cell += f"(rel {rel:.1e})"
            cells.append(cell)
        counts = work_counts(plan.live_taps(), w_in, plan.stride, b)
        print(f"[time] {what} g{tuple(g.shape)} "
              f"bound_ms={1e3 * flops / PEAK_FP32_FLOPS:.3f} "
              f"units={counts['units']} "
              f"staged_gb={counts['staged_gb']:.2f} "
              f"mma={counts['mma']:.3e} "
              f"live_share={counts['live_share']:.2f} "
              + " ".join(cells), flush=True)
        del g, ref, bufs, taps, rows
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
