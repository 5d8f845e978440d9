"""Build, inspect and verify warm-start bundles of the port.

A bundle turns replica boot from kernel builds and plan construction
into an artifact load: it packs the kernel libraries, the precomputed
SHT/DISCO geometry plans and the engine-pool manifest for a declared set
of request shapes (see ``repro_torch.serving.bundle``), and with
``--tuning-dir`` the kernel tunings and their libraries.  The JAX
package's ``repro.launch.bundle``, plus ``--device``.

Build (on a machine with the exact torch and CUDA versions, card and
source tree the replicas will run)::

  PYTHONPATH=src python -m repro_torch.launch.bundle build \
      --spec '{"members": 2, "lead_steps": 4, "lead_chunk": 2}' \
      --max-batch 2 --out bundles/smoke [--tuning-dir .tuning] \
      [--device cpu]

Boot a replica from it (refuses on any mismatch instead of building)::

  PYTHONPATH=src python -m repro_torch.launch.service --bundle bundles/smoke

Inspect / verify a published bundle::

  PYTHONPATH=src python -m repro_torch.launch.bundle inspect bundles/smoke
  PYTHONPATH=src python -m repro_torch.launch.bundle verify bundles/smoke
"""

from __future__ import annotations

import argparse
import json
import logging

_log = logging.getLogger("repro_torch.launch.bundle")


def _cmd_build(args: argparse.Namespace) -> int:
    from repro_torch.serving.bundle import WarmStartBundle, pack
    from repro_torch.serving.spec import RequestSpec
    specs = []
    for raw in args.spec:
        spec = RequestSpec.from_dict(json.loads(raw))
        spec.validate()
        specs.append(spec)
    ckpts = {specs[0].config: args.ckpt} if args.ckpt else None
    if args.tuning_dir:
        # install before warming: the bundled keys (and engines) must be
        # the tuned ones, and pack() ships the entries under tunings/
        from repro_torch.kernels import autotune
        cache = autotune.TuningCache(args.tuning_dir)
        autotune.install_tuning_cache(cache)
        _log.info("tuning cache installed: %s", cache.stats())
    out = pack(specs, out=args.out, max_batch=args.max_batch,
               ckpts=ckpts, tar=args.tar, out_dir=args.out_dir,
               verbose=True, device=args.device)
    b = WarmStartBundle.load(out)
    _log.info("built %s at %s (%d engine(s), %d file(s))",
              b.bundle_id, out, len(b.manifest["engines"]),
              len(b.manifest["files"]))
    # the bundle path is the build's one stdout line: scripts capture it
    # with `... | tail -n 1` (progress goes to stderr via logging)
    print(out)
    return 0


def _cmd_inspect(args: argparse.Namespace) -> int:
    from repro_torch.serving.bundle import WarmStartBundle
    b = WarmStartBundle.load(args.bundle)
    m = b.manifest
    total = sum(f["bytes"] for f in m["files"].values())
    print(json.dumps({
        "bundle_id": m.get("bundle_id"),
        "format": m.get("format"),
        "environment": m.get("environment"),
        "engines": m.get("engines"),
        "plans": m.get("plans"),
        "tunings": m.get("tunings"),
        "libraries": m.get("libraries"),
        "files": len(m.get("files", {})),
        "total_bytes": total,
    }, indent=2))
    return 0


def _cmd_verify(args: argparse.Namespace) -> int:
    from repro_torch.serving.bundle import BundleError, WarmStartBundle
    b = WarmStartBundle.load(args.bundle)
    try:
        b.verify(deep=not args.shallow, device=args.device)
    except BundleError as e:
        print(f"[bundle] REFUSED: {e}")
        return 1
    print(f"[bundle] OK: {b.bundle_id} is servable by this process "
          f"({len(b.manifest['engines'])} engine(s))")
    return 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="warm + pack a warm-start bundle")
    b.add_argument("--spec", action="append", required=True,
                   metavar="SPEC_JSON",
                   help="RequestSpec JSON to bundle (repeatable)")
    b.add_argument("--max-batch", type=int, default=1,
                   help="also warm the coalesced B-request keys "
                        "(match the service's --max-batch)")
    b.add_argument("--ckpt", default=None,
                   help="checkpoint for the first spec's config")
    b.add_argument("--out", default=None,
                   help="exact output path (default: content-addressed "
                        "name under --out-dir)")
    b.add_argument("--out-dir", default="bundles",
                   help="directory for content-addressed bundle names")
    b.add_argument("--tar", action="store_true",
                   help="produce a single .tar archive instead of a "
                        "directory")
    b.add_argument("--tuning-dir", default=None, metavar="DIR",
                   help="install this kernel TuningCache before warming: "
                        "the bundled engines use its tiles, and its "
                        "entries and their libraries ship in the "
                        "bundle's tunings/ and blobs/")
    b.add_argument("--device", default="cuda",
                   help="device the bundle is built for (the replicas' "
                        "own); 'cpu' must be asked for")
    b.set_defaults(fn=_cmd_build)

    i = sub.add_parser("inspect", help="print a bundle's manifest summary")
    i.add_argument("bundle")
    i.set_defaults(fn=_cmd_inspect)

    v = sub.add_parser("verify",
                       help="check the bundle against this environment "
                            "(exit 1 on refusal)")
    v.add_argument("bundle")
    v.add_argument("--shallow", action="store_true",
                   help="skip per-file sha256 checks")
    v.add_argument("--device", default="cuda",
                   help="device the replica would run on")
    v.set_defaults(fn=_cmd_verify)

    args = ap.parse_args(argv)
    from repro_torch.serving.observability import setup_logging
    setup_logging()
    raise SystemExit(args.fn(args))


if __name__ == "__main__":
    main()
