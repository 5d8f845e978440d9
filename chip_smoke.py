#!/usr/bin/env python3
"""Drive the PyTorch port of FCN3 on one CUDA card and check its kernels.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a
non-zero exit code and no result line:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   and the ``nvcc`` build of every kernel source (one process each, in
   parallel);
2. the main path: ``repro_torch.launch.serve``'s scored ensemble forecast
   (calibrated init, then members x leads against synthetic truth) with
   every kernel launch counter set to 0 just before and read just after;
   every kernel must have launched, every score must be finite;
3. a small-input check: one ``fcn3_smoke`` step on the card through the
   kernels against the port's reference (FFT/einsum) path;
4. every kernel against its plain torch version, on the card, at each
   distinct shape the main path launched it with; timings (CUDA events,
   median), the ``library_ms`` yardstick and the least time the card
   could take (``bound_ms``);
5. the ``kernels`` JSON line, then the result line.

Exits non-zero without CUDA, and in a directory without the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
#: cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
#: kernel vs plain: max |kernel - plain| <= REL_TOL * max |plain|
#: (fp32 sums of up to S*D = 3.3k terms in another order)
REL_TOL = 1e-4
#: the main path: fcn3_full at its published widths, 2 members x 2 leads,
#: after this many LSUV calibration rounds (the serve CLI runs 4)
CONFIG, MEMBERS, LEAD_STEPS = "full", 2, 2
CALIBRATION_ROUNDS = 1


def log(msg: str) -> None:
    """Print one line and flush it (the output is read as it arrives)."""
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of ``fn`` in ms (CUDA events, after warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class Recorder:
    """Wraps the kernel wrappers' module attributes to note the operands
    of every main-path call (the wrappers still count the launches)."""

    def __init__(self):
        from repro_torch.kernels.disco import ops as disco_ops
        from repro_torch.kernels.legendre import ops as legendre_ops
        self.disco: dict = {}
        self.legendre: dict = {}
        self._mods = (disco_ops, legendre_ops)
        self._orig = (disco_ops.disco_band_contract,
                      legendre_ops.legendre_contract)

        def disco(x, psi_band, lat_idx, stride=1):
            key = (psi_band.data_ptr(), stride)
            ent = self.disco.setdefault(key, {"psi": psi_band,
                                              "lat_idx": lat_idx,
                                              "stride": stride, "b": 0,
                                              "shape": None})
            if x.shape[0] > ent["b"]:
                ent["b"], ent["shape"] = x.shape[0], tuple(x.shape)
            return self._orig[0](x, psi_band, lat_idx, stride)

        def legendre(x, table):
            key = (table.data_ptr(), table.stride())
            ent = self.legendre.setdefault(key, {"table": table, "b": 0,
                                                 "shape": None,
                                                 "dtype": x.dtype})
            if x.shape[0] > ent["b"]:
                ent["b"], ent["shape"] = x.shape[0], tuple(x.shape)
            return self._orig[1](x, table)

        disco_ops.disco_band_contract = disco
        legendre_ops.legendre_contract = legendre

    def close(self) -> None:
        """Put the original wrappers back."""
        self._mods[0].disco_band_contract = self._orig[0]
        self._mods[1].legendre_contract = self._orig[1]


def errors(got, ref) -> tuple[float, float]:
    """Max abs error and that error relative to max |ref|."""
    diff = float((got - ref).abs().max())
    return diff, diff / max(float(ref.abs().max()), 1e-30)


def check_legendre(table, shape, dtype, name) -> dict:
    """Legendre kernel vs its plain version at one main-path shape."""
    import torch
    from repro_torch.kernels.legendre import ops
    from repro_torch.kernels.legendre.ref import legendre_contract_ref
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    got = ops.legendre_contract(x, table)
    torch.cuda.synchronize()
    ref = legendre_contract_ref(x, table)
    torch.cuda.synchronize()
    abs_err, rel_err = errors(got, ref)
    del got, ref
    b, k, m = shape
    n = table.shape[1]
    parts = 2 if x.is_complex() else 1     # real and imaginary rows
    ms = cuda_ms(lambda: ops.legendre_contract(x, table), reps=10)
    plain_ms = cuda_ms(lambda: legendre_contract_ref(x, table), reps=5)
    # yardstick: torch.bmm on m-major operands, permuted beforehand
    xr = torch.view_as_real(x) if parts == 2 else x[..., None]
    xm = xr.permute(2, 0, 3, 1).reshape(m, parts * b, k)
    tm = table.permute(2, 0, 1).contiguous()
    lib_ms = cuda_ms(lambda: torch.bmm(xm, tm), reps=10)
    del xm, tm
    # the tables are zero for m > l: count the products the data needs
    nnz = int((table != 0).sum())
    flops = 2.0 * parts * b * nnz
    flops_dense = 2.0 * parts * b * k * n * m
    nbytes = 4.0 * (parts * b * k * m + k * n * m + parts * b * n * m)
    row = dict(shape=f"x{shape} {str(dtype).split('.')[-1]} "
               f"table{tuple(table.shape)}", what=name,
               max_abs_err=abs_err, max_rel_err=rel_err, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, flops=flops,
               flops_dense=flops_dense, bytes=nbytes, **bound(flops, nbytes))
    log(f"[kernel] legendre {name} {row['shape']}: abs_err={abs_err:.3e} "
        f"rel_err={rel_err:.3e} ms={ms:.3f} plain_ms={plain_ms:.3f} "
        f"bmm_ms={lib_ms:.3f} bound_ms={row['bound_ms']:.3f} "
        f"dense_tflops={flops_dense / ms / 1e9:.2f}")
    if not rel_err <= REL_TOL:
        raise AssertionError(f"legendre {name}: kernel disagrees with its "
                             f"plain version (rel {rel_err:.3e})")
    return row


def check_disco(ent, name) -> dict:
    """Banded DISCO kernel vs its plain version at one main-path shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.disco import ops
    from repro_torch.kernels.disco.ref import disco_gather_band_contract_ref
    psi, lat_idx, stride, shape = (ent["psi"], ent["lat_idx"], ent["stride"],
                                   ent["shape"])
    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(shape, generator=g, device="cuda")
    got = ops.disco_band_contract(x, psi, lat_idx, stride)
    torch.cuda.synchronize()
    ref = disco_gather_band_contract_ref(x, psi, lat_idx, stride)
    torch.cuda.synchronize()
    abs_err, rel_err = errors(got, ref)
    del got
    b, h_in, w_in = shape
    k, h_out, s, d = psi.shape
    w_out = w_in // stride
    ms = cuda_ms(lambda: ops.disco_band_contract(x, psi, lat_idx, stride),
                 reps=5)
    plain_ms = cuda_ms(
        lambda: disco_gather_band_contract_ref(x, psi, lat_idx, stride),
        reps=2, warmup=0)
    # yardstick: one grouped conv1d over the rolled, gathered, wrap-padded
    # rows computes the same band correlation (cuDNN, TF32 off)
    xr = torch.roll(x, d // 2, dims=-1)
    xg = xr.index_select(-2, lat_idx.reshape(-1).long()).reshape(
        b, h_out, s, w_in)
    del xr
    xp = torch.cat([xg, xg[..., :d - 1]], dim=-1).reshape(b, h_out * s, -1)
    del xg
    wt = psi.permute(1, 0, 2, 3).reshape(h_out * k, s, d).contiguous()

    def lib():
        return F.conv1d(xp, wt, stride=stride, groups=h_out)

    lib_out = lib().reshape(b, h_out, k, w_out).permute(0, 2, 1, 3)
    lib_err = errors(lib_out, ref)[1]
    del lib_out, ref
    lib_ms = cuda_ms(lib, reps=3)
    del xp
    nnz = int((psi != 0).sum())
    flops_dense = 2.0 * k * h_out * s * d * w_out * b
    flops = 2.0 * nnz * w_out * b   # the taps this filter really has
    nbytes = 4.0 * (b * h_in * w_in + psi.numel() + lat_idx.numel()
                    + b * k * h_out * w_out)
    row = dict(shape=f"x{shape} psi{tuple(psi.shape)} stride{stride}",
               what=name, max_abs_err=abs_err, max_rel_err=rel_err, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, library_rel_err=lib_err,
               flops=flops, flops_dense=flops_dense, bytes=nbytes,
               **bound(flops, nbytes))
    log(f"[kernel] disco {name} {row['shape']}: abs_err={abs_err:.3e} "
        f"rel_err={rel_err:.3e} ms={ms:.3f} plain_ms={plain_ms:.3f} "
        f"conv1d_ms={lib_ms:.3f} (rel_err {lib_err:.1e}) "
        f"bound_ms={row['bound_ms']:.3f} "
        f"dense_band_tflops={flops_dense / ms / 1e9:.2f}")
    if not rel_err <= REL_TOL:
        raise AssertionError(f"disco {name}: kernel disagrees with its "
                             f"plain version (rel {rel_err:.3e})")
    return row


def bound(flops: float, nbytes: float) -> dict:
    """Least time on the card: the larger of operations and bytes."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def small_input_check() -> float:
    """fcn3_smoke on the card: kernel path vs the reference path."""
    import dataclasses
    import torch
    from repro_torch.configs import fcn3 as cfgs
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.kernels.config import KernelConfig
    outs = []
    for mode in ("kernel", "reference"):
        cfg = dataclasses.replace(cfgs.fcn3_smoke(),
                                  kernels=KernelConfig(mode, mode))
        model = FCN3(cfg, device="cuda")
        model.init(torch.Generator(device="cuda").manual_seed(3))
        g = torch.Generator(device="cuda").manual_seed(4)
        state = torch.randn((2, cfg.n_state, cfg.nlat, cfg.nlon),
                            generator=g, device="cuda")
        cond = torch.randn((2, cfg.n_cond_in, cfg.nlat, cfg.nlon),
                           generator=g, device="cuda")
        with torch.inference_mode():
            outs.append(model(model.make_buffers(), state, cond))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-5)
    return float((outs[0] - outs[1]).abs().max())


def main() -> int:
    """Run every phase; 0 only when all of them pass."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.disco import ops as disco_ops
    from repro_torch.kernels.legendre import ops as legendre_ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.runtime import set_precision
    set_precision()
    torch.backends.cudnn.benchmark = False

    # -- phase 1: card, versions, build ----------------------------------
    card = card_line()
    log(f"[card] {card}")
    log(f"[versions] python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
        f" count {torch.cuda.device_count()}")
    t0 = time.time()
    build.build_all()
    log(f"[build] {len(build.SOURCES)} kernels built in "
        f"{time.time() - t0:.1f}s (sm_90a)")
    for name, text in build.build_logs.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"[build] {name}: {ln.strip()}")

    # -- phase 2: the main path -------------------------------------------
    rec = Recorder()
    stamps: list[float] = []

    def report(line: str) -> None:
        stamps.append(time.time())
        log(line if line.startswith("[") else f"[serve] {line}")

    torch.cuda.reset_peak_memory_stats()
    disco_ops.reset_launches()
    legendre_ops.reset_launches()
    t0 = time.time()
    results = serve_mod.serve(
        CONFIG, MEMBERS, LEAD_STEPS, lead_chunk=1,
        device="cuda", calibration_rounds=CALIBRATION_ROUNDS, report=report)
    torch.cuda.synchronize()
    total_s = time.time() - t0
    launches = {"disco_band_contract": disco_ops.launches,
                "legendre_contract": legendre_ops.launches}
    rec.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lead_s = [b - a for a, b in zip(stamps[:-1], stamps[1:-1])]
    log(f"[main] config={CONFIG} members={MEMBERS} "
        f"leads={LEAD_STEPS} calibration_rounds={CALIBRATION_ROUNDS} "
        f"total_s={total_s:.1f} "
        f"setup_and_calibration_s={stamps[0] - t0:.1f} "
        f"per_lead_s={[round(s, 2) for s in lead_s]} "
        f"peak_mem_gb={peak_gb:.2f} launches={launches}")
    for name in ("crps", "ens_rmse", "spread", "ssr"):
        vals = torch.cat([r.scores[name] for r in results])
        if vals.shape[0] != LEAD_STEPS or not torch.isfinite(vals).all():
            raise AssertionError(f"score {name} not finite / wrong shape "
                                 f"{tuple(vals.shape)}")
    final = results[-1].final_state
    if not torch.isfinite(final).all():
        raise AssertionError("final ensemble state is not finite")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    del results, final

    # -- phase 3: small input against the reference path -------------------
    err = small_input_check()
    log(f"[check] fcn3_smoke kernel path vs reference path on the card: "
        f"max_abs_err={err:.3e} (rtol=1e-4, atol=1e-5)")

    # -- phase 4: kernels against their plain versions ---------------------
    rows = {"legendre_contract": [], "disco_band_contract": []}
    for ent in rec.legendre.values():
        # the inverse SHT passes pct as a transposed (L, H, M) view
        what = "forward" if ent["table"].is_contiguous() else "inverse"
        rows["legendre_contract"].append(
            check_legendre(ent["table"], ent["shape"], ent["dtype"], what))
    for ent in rec.disco.values():
        _, h_in, w_in = ent["shape"]
        what = (f"{h_in}x{w_in}->{ent['psi'].shape[1]}x"
                f"{w_in // ent['stride']}")
        rows["disco_band_contract"].append(check_disco(ent, what))
        torch.cuda.empty_cache()

    meta = {
        "legendre_contract": ("cuda", "src/repro_torch/csrc/legendre.cu",
                              "src/repro/kernels/legendre/legendre.py:91"),
        "disco_band_contract": ("cuda", "src/repro_torch/csrc/disco_band.cu",
                                "src/repro/kernels/disco/disco.py:110"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        top = max(rows[name], key=lambda r: r["flops"])
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "at": top["shape"],
            "shapes": rows[name]})
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
