"""Self-test of the distributed spherical ops in a world of 8 processes.

    python -m repro_torch.distributed.selftest [--device cuda|cpu]
                                               [--backend gloo|nccl]

Runs on the card unless ``--device cpu`` is given; without a card and
without that flag it exits with an error instead of running on the CPU.

Spawns 8 ranks (``world.run_world``: the ``spawn`` start method, a
``FileStore`` in a temporary directory) as an (ens 2, lat 2, lon 2)
mesh, and checks at the JAX package's selftest shapes and bars, every
rank against the single-process port's plain path on its own block:

  * distributed SHT forward / inverse == ``core.sphere.sht`` (Alg. 1),
    bar 1e-4;
  * distributed DISCO == ``core.sphere.disco.disco_conv`` (Alg. 2), with
    the masked per-rank band (the band kernel on ``cuda``) and with the
    JAX package's dense masked psi, bar 1e-4 of max |ref|;
  * distributed ensemble CRPS == ``core.crps.crps_ensemble`` summed with
    the area weights (Alg. 3), biased and fair, bar 1e-5 of |ref|.

On ``cuda`` the Legendre, band and CRPS kernels run inside the bodies
(their libraries are built in this process before the ranks start; a
world of 8 ranks on one card must take ``--backend gloo``: NCCL refuses
two ranks on one device).  Prints ``dist_sht: OK``, ``dist_disco: OK``,
``dist_crps: OK``, each rank's kernel launches, and ``ALL DISTRIBUTED
CHECKS PASSED``; exits 1 on a failed check.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

MESH, AXES = (2, 2, 2), ("ens", "lat", "lon")
SHT_TOL, DISCO_TOL, CRPS_TOL = 1e-4, 1e-4, 1e-5


def _rng(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def check_dist_sht(groups, coord, dev) -> dict[str, float]:
    """Forward and inverse max abs errors of this rank's block."""
    from repro_torch.core.sphere import grids, sht
    from repro_torch.distributed import dist_sht
    _, la, lo = coord
    t = sht.SHT.create(grids.make_grid(32, 64, "gauss"), lmax=32, mmax=32)
    bufs = t.buffers(dev)
    x = torch.from_numpy(_rng(0, (2, 8, 32, 64))).to(dev)
    m0, m1 = dist_sht.order_block(t.mmax, MESH[2], lo)
    local = dist_sht.local_sht_buffers(t, m0, m1, dev)
    xb = x[:, :, la * 16:(la + 1) * 16, lo * 32:(lo + 1) * 32]
    c = dist_sht.dist_sht_forward(xb, local, t.mmax, groups["lat"],
                                  groups["lon"])
    c_ref = t.forward(x, bufs)
    fwd = float((c - c_ref[:, :, la * 16:(la + 1) * 16, m0:m1]).abs().max())
    u = dist_sht.dist_sht_inverse(
        c_ref[:, :, la * 16:(la + 1) * 16, m0:m1].contiguous(), local, 64,
        groups["lat"], groups["lon"])
    u_ref = t.inverse(c_ref, bufs)
    inv = float((u - u_ref[:, :, la * 16:(la + 1) * 16,
                           lo * 32:(lo + 1) * 32]).abs().max())
    return {"forward": fwd, "inverse": inv}


def check_dist_disco(groups, coord, dev) -> dict[str, float]:
    """Max abs error of this rank's block over max |ref|, for the band
    layout and for the dense masked psi."""
    from repro_torch.core.sphere import disco, grids
    from repro_torch.distributed import dist_disco
    _, la, lo = coord
    g = grids.make_grid(32, 64, "equiangular")
    plan = disco.make_disco_plan(g, g, cutoff_factor=3.0)
    x = torch.from_numpy(_rng(1, (2, 8, 32, 64))).to(dev)
    ref = disco.disco_conv(x, torch.from_numpy(plan.psi).to(dev),
                           torch.from_numpy(plan.lat_idx).to(dev),
                           plan.stride)
    ref_b = ref[..., la * 16:(la + 1) * 16, lo * 32:(lo + 1) * 32]
    scale = max(float(ref.abs().max()), 1.0)
    xb = x[:, :, la * 16:(la + 1) * 16, lo * 32:(lo + 1) * 32]
    blocks, _ = dist_disco.local_psi_blocks(plan, MESH[1])
    out = {}
    for name, local in (
            ("band", dist_disco.local_band_buffers(plan, la, MESH[1], dev)),
            ("dense", torch.from_numpy(blocks[la]).to(dev))):
        got = dist_disco.dist_disco_conv(xb, local, plan.stride,
                                         groups["lat"], groups["lon"])
        out[name] = float((got - ref_b).abs().max()) / scale
    return out


def check_dist_crps(groups, coord, dev) -> dict[str, float]:
    """|dist - ref| over max(|ref|, 1), biased and fair."""
    from repro_torch.core import crps
    from repro_torch.core.sphere import grids
    from repro_torch.distributed import dist_crps
    e = coord[0]
    aw = torch.from_numpy(grids.make_grid(16, 32, "gauss").area_weights_2d()
                          .astype(np.float32).reshape(-1)).to(dev)
    ens = torch.from_numpy(_rng(2, (4, 16 * 32))).to(dev)
    obs = torch.from_numpy(_rng(3, (16 * 32,))).to(dev)
    out = {}
    for fair in (False, True):
        ref = float((crps.crps_ensemble(ens, obs, 0, fair) * aw).sum())
        got = float(dist_crps.dist_crps(ens[2 * e:2 * e + 2], obs, aw,
                                        groups["ens"], fair))
        out["fair" if fair else "biased"] = abs(got - ref) / max(abs(ref),
                                                                 1.0)
    return out


def rank_checks(rank: int, world_size: int, device: str) -> dict:
    """The three checks on this rank of the (ens, lat, lon) mesh; returns
    their errors and this rank's kernel launches."""
    from repro_torch.kernels.crps import ops as crps_ops
    from repro_torch.kernels.disco import ops as disco_ops
    from repro_torch.kernels.legendre import ops as legendre_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import resolve_device
    dev = resolve_device(device)
    mesh = make_mesh(MESH, AXES, dev.type)
    groups = {a: mesh.get_group(a) for a in AXES}
    coord = tuple(mesh.get_coordinate())
    for mod in (crps_ops, disco_ops, legendre_ops):
        mod.reset_launches()
    errs = {"sht": check_dist_sht(groups, coord, dev),
            "disco": check_dist_disco(groups, coord, dev),
            "crps": check_dist_crps(groups, coord, dev)}
    return {"errors": errs, "coord": coord,
            "launches": {"legendre": legendre_ops.launches,
                         "disco_band": disco_ops.launches,
                         "crps": crps_ops.launches}}


def run(device: str = "cuda", backend: str = "gloo", timeout: float = 300.0,
        report=print) -> list[dict]:
    """Run the world on ``device`` (the card unless ``"cpu"`` is asked
    for; ``RuntimeError`` without one), print the check lines; raises
    ``AssertionError`` on a failed check.  Returns every rank's result."""
    from repro_torch.runtime import resolve_device
    device = resolve_device(device).type
    if device == "cuda":
        from repro_torch.kernels import build
        build.build_all(("legendre", "disco_band", "crps"))
    from repro_torch.distributed.world import run_world
    results = run_world(rank_checks, int(np.prod(MESH)), (device,),
                        backend=backend, timeout=timeout, threads=1)

    def worst(check, key):
        return max(r["errors"][check][key] for r in results)

    checks = (("dist_sht", [("sht", "forward", SHT_TOL),
                            ("sht", "inverse", SHT_TOL)]),
              ("dist_disco", [("disco", "band", DISCO_TOL),
                              ("disco", "dense", DISCO_TOL)]),
              ("dist_crps", [("crps", "biased", CRPS_TOL),
                             ("crps", "fair", CRPS_TOL)]))
    failed = []
    for name, parts in checks:
        errs = {f"{c}.{k}": worst(c, k) for c, k, _ in parts}
        bad = [f"{c}.{k}" for c, k, tol in parts if not worst(c, k) < tol]
        if bad:
            failed.append(f"{name} mismatch: {errs}")
            report(f"{name}: FAILED {errs}")
        else:
            report(f"{name}: OK " + " ".join(f"{k}={v:.2e}"
                                             for k, v in errs.items()))
    report(f"launches per rank ({device}, backend={backend}, "
           f"{len(results)} ranks): "
           + "; ".join(f"{r['coord']} " + " ".join(
               f"{k}={v}" for k, v in r["launches"].items())
               for r in results))
    if failed:
        raise AssertionError("; ".join(failed))
    report("ALL DISTRIBUTED CHECKS PASSED")
    return results


def main(argv: list[str] | None = None) -> int:
    """The selftest CLI."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="'cpu' must be asked for")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    try:
        run(args.device, args.backend, args.timeout)
    except AssertionError as e:
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
