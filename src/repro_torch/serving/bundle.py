"""Content-addressed warm-start bundles: zero-cold-start replicas.

A fresh serving replica normally builds its kernel libraries (``nvcc``)
and its geometry plans before its first forecast.  A **bundle** packs
what a warm process accumulated, so a new replica boots by *loading*
instead of *building*:

* ``blobs/lib<name>-<sha>.so`` -- the kernel libraries the bundled
  engines launch, under their content-addressed names (the serving
  cache's persisted "executables"; loaded with
  ``kernels.build.load_library_from``, no ``nvcc``), tuned variants
  included, and the library of every packed tuning's winner; the
  manifest's ``libraries`` names each file's source and defines.  Empty
  on the CPU, where the wrappers run their plain versions;
* ``tunings/tune_<token>.json`` -- the entries of the tuning cache that
  was active at build (``kernels.autotune``): a booting replica installs
  them, so its engines resolve the same tiles, hence the same keys,
  with no sweep;
* ``plans/*.npz`` -- precomputed geometry: DISCO psi tensors with their
  banded splits and the SHT Legendre tables, in the JAX package's npz
  format (``repro.serving.bundle``), so each package installs the
  other's plans;
* ``manifest.json`` -- the engine-pool manifest: which request shapes
  (``RequestSpec``), coalesced batch sizes, chunk lengths and key tokens
  the bundle serves, plus per-file sha256 hashes and the environment the
  bundle was built in.

The reference's ``xla/`` (its persistent compilation cache) and
``set_xla_cache_dir`` have no counterpart: the port has no compiled
program to cache.

**Key hygiene.**  A bundle is only valid for the exact (torch version,
CUDA version, device, ``repro_torch`` source fingerprint) it was built
for -- the same scoping ``ExecutableKey.token`` uses.  ``bundle_id`` is
the sha256 of the canonical manifest (content addressing: two builds of
identical content agree on the id; any edit changes it).

**Refusal semantics.**  A replica booting from a bundle must never
silently build: ``WarmStartBundle.verify`` refuses on any environment or
hash mismatch with a diagnostic naming the exact field, and the boot
path uses ``ExecutableCache(readonly=True)``, which raises
``ReadOnlyCacheMiss`` instead of running ``nvcc`` or building a plan.

This module stays importable without torch (like the rest of the client
surface); torch and the scheduler stack are imported inside the
functions that need them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
import tarfile
import tempfile
import time

import numpy as np

from repro_torch.serving.cache import ExecutableKey, ReadOnlyCacheMiss
from repro_torch.serving.spec import RequestSpec

_logger = logging.getLogger("repro_torch.serving.bundle")

#: manifest schema version; bump on any incompatible layout change (the
#: JAX package's bundles, "fcn3-warm-bundle/1", hold StableHLO instead)
BUNDLE_FORMAT = "fcn3-torch-warm-bundle/1"

#: environment fields that must match exactly for a bundle to be usable
#: (each one invalidates the kernel libraries or the key tokens)
_STRICT_ENV = ("torch", "cuda", "device", "source_fingerprint")


class BundleError(RuntimeError):
    """A bundle cannot be built, verified or booted; the message says
    exactly which manifest field, file or key failed."""


def environment(device="cuda") -> dict:
    """The environment fingerprint a bundle is keyed by, for a replica
    on ``device``: ``torch``/``cuda``/``device``/``source_fingerprint``
    must match exactly between build and boot; ``python`` is recorded
    for diagnostics only."""
    import platform

    from repro_torch.serving import cache
    return {**cache.environment(device),
            "python": platform.python_version()}


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _canonical(manifest: dict) -> bytes:
    """Canonical manifest bytes for content addressing: sorted keys,
    compact separators, ``bundle_id`` itself excluded."""
    trimmed = {k: v for k, v in manifest.items() if k != "bundle_id"}
    return json.dumps(trimmed, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def _save_plan_npz(path: str, payload: dict) -> None:
    """One plan payload -> npz: arrays as entries, scalars as a JSON
    ``__meta__`` byte array (npz has no native scalar metadata)."""
    arrays = {k: v for k, v in payload.items() if isinstance(v, np.ndarray)}
    meta = {k: v for k, v in payload.items() if k not in arrays}
    blob = json.dumps(meta).encode("utf-8")
    np.savez(path, __meta__=np.frombuffer(blob, np.uint8), **arrays)


def _load_plan_npz(path: str) -> dict:
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode("utf-8"))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return {**meta, **arrays}


def _install_plan_payload(payload: dict) -> None:
    """Install one deserialized plan payload into the matching
    geometry-cache override registry."""
    kind = payload.get("kind")
    if kind == "disco":
        from repro_torch.core.sphere import disco as discolib
        discolib.install_plan(payload)
    elif kind == "legendre":
        from repro_torch.core.sphere import legendre as leg
        leg.install_legendre_table(
            int(payload["lmax"]), int(payload["mmax"]),
            np.asarray(payload["colat"], np.float64),
            np.asarray(payload["table"], np.float64))
    else:
        raise BundleError(f"unknown plan payload kind {kind!r}")


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

def pack(specs: list[RequestSpec], out: str | None = None,
         max_batch: int = 1, ckpts: dict[str, str] | None = None,
         tar: bool = False, out_dir: str = "bundles",
         verbose: bool = False, device="cuda") -> str:
    """Build a warm-start bundle for ``specs`` on ``device`` and return
    its path.

    Builds the model pool on ``device`` and warms the serial keys of
    every spec (plus the coalesced ``max_batch``-request keys when
    ``max_batch`` > 1) over a cache persisting into ``blobs/``, then
    packs the kernel libraries, the geometry plans and the engine-pool
    manifest.  With ``out=None`` the bundle is written to
    ``<out_dir>/fcn3-bundle-<bundle_id[:12]>`` (content-addressed name);
    ``tar=True`` produces a single ``.tar`` archive instead of a
    directory.
    """

    def _log(msg: str) -> None:
        # verbose promotes build progress to INFO; it always remains
        # visible at DEBUG for anyone wiring up repro_torch.* logging
        _logger.log(logging.INFO if verbose else logging.DEBUG, msg)

    # staging lives next to the final path so the finalizing rename is
    # atomic (same filesystem)
    if out is not None:
        base = os.path.dirname(os.path.abspath(out))
    else:
        base = out_dir
    os.makedirs(base, exist_ok=True)
    staging = tempfile.mkdtemp(prefix=".fcn3-bundle-build-", dir=base)
    try:
        blobs_dir = os.path.join(staging, "blobs")

        from repro_torch.inference.engine import kernel_libraries
        from repro_torch.serving.cache import ExecutableCache
        from repro_torch.serving.scheduler import (ForecastScheduler,
                                                   ModelPool)
        pool = ModelPool(ckpts, device=device)
        sched = ForecastScheduler(
            pool=pool, cache=ExecutableCache(persist_dir=blobs_dir))
        engines: list[dict] = []
        plan_payloads: list[dict] = []
        plan_seen: set = set()
        libraries: set = set()
        try:
            for spec in specs:
                spec.validate()
                _log(f"warming {spec.to_dict()}")
                batches = [None] + ([max_batch] if max_batch > 1 else [])
                programs = []
                for b in batches:
                    out_warm = sched.warmup(spec, batch=b)
                    engine, _ = sched.engine_for(spec)
                    lens = engine.chunk_lengths(spec.lead_steps)
                    tokens = [ExecutableKey.for_engine(
                        spec.config, engine, spec.scored, k,
                        batch=b).token(pool.device) for k in lens]
                    programs.append({
                        "batch": b, "chunk_lengths": lens,
                        "tokens": tokens,
                        "compile_s": round(out_warm["compile_s"], 3)})
                engine, _ = sched.engine_for(spec)
                # the engine's libraries, and those of the model's own
                # config, which a replica's calibration at boot launches
                libraries.update(engine.kernel_libraries())
                libraries.update(kernel_libraries(pool.get(
                    spec.config).model))
                engines.append({
                    "spec": spec.to_dict(), "programs": programs,
                    "estimated_bytes": engine.estimated_bytes()})
                for payload in engine.plan_exports():
                    pk = (payload["kind"],
                          json.dumps(payload.get("key",
                                                 [payload.get("lmax"),
                                                  payload.get("mmax")])))
                    if pk in plan_seen:
                        continue
                    plan_seen.add(pk)
                    plan_payloads.append(payload)
        finally:
            sched.close()

        plans_dir = os.path.join(staging, "plans")
        os.makedirs(plans_dir, exist_ok=True)
        plan_files = []
        for i, payload in enumerate(plan_payloads):
            name = f"plan_{i:02d}_{payload['kind']}.npz"
            _save_plan_npz(os.path.join(plans_dir, name), payload)
            plan_files.append(f"plans/{name}")
        _log(f"exported {len(plan_files)} geometry plan(s)")

        # the active tuning cache: the engines above were warmed with the
        # tiles it resolved into engine_config, so a booting replica must
        # resolve the same ones to derive the same keys; each entry's
        # winning library rides along in blobs/
        from repro_torch.kernels import autotune, build
        tuning_files = []
        active = autotune.active_tuning_cache()
        if active is not None:
            tunings_dir = os.path.join(staging, "tunings")
            os.makedirs(tunings_dir, exist_ok=True)
            for name, entry in active.entries():
                shutil.copyfile(os.path.join(active.root, name),
                                os.path.join(tunings_dir, name))
                tuning_files.append(f"tunings/{name}")
                libraries.add(autotune.library_for(entry["op"],
                                                   entry["dims"]))
            _log(f"packed {len(tuning_files)} kernel tuning(s)")
        library_list = []
        for name, defines in sorted(libraries):
            blob = os.path.join(blobs_dir, build.library_file(name, defines))
            if not os.path.exists(blob):
                src = build.library_path(name, defines)
                if not src.exists():
                    build.build_all([(name, defines)])
                os.makedirs(blobs_dir, exist_ok=True)
                shutil.copyfile(src, blob)
            library_list.append({
                "file": f"blobs/{os.path.basename(blob)}", "name": name,
                "defines": [list(d) for d in defines]})

        files = {}
        for dirpath, dirnames, filenames in os.walk(staging):
            dirnames.sort()
            for name in sorted(filenames):
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, staging).replace(os.sep, "/")
                files[rel] = {"sha256": _sha256_file(path),
                              "bytes": os.path.getsize(path)}

        manifest = {
            "format": BUNDLE_FORMAT,
            "environment": environment(pool.device),
            "engines": engines,
            "plans": plan_files,
            "tunings": tuning_files,
            "libraries": library_list,
            "files": files,
        }
        bundle_id = hashlib.sha256(_canonical(manifest)).hexdigest()
        manifest["bundle_id"] = bundle_id
        with open(os.path.join(staging, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)

        if out is None:
            os.makedirs(out_dir, exist_ok=True)
            out = os.path.join(out_dir, f"fcn3-bundle-{bundle_id[:12]}")
            if tar:
                out += ".tar"
        if os.path.exists(out):
            raise BundleError(f"bundle path {out!r} already exists; "
                              f"refusing to overwrite")
        if tar or out.endswith(".tar"):
            parent = os.path.dirname(out)
            if parent:
                os.makedirs(parent, exist_ok=True)
            tmp = f"{out}.tmp.{os.getpid()}"
            with tarfile.open(tmp, "w") as tf:
                for rel in sorted([*files, "manifest.json"]):
                    tf.add(os.path.join(staging, rel), arcname=rel,
                           recursive=False)
            os.replace(tmp, out)
            shutil.rmtree(staging, ignore_errors=True)
        else:
            parent = os.path.dirname(out)
            if parent:
                os.makedirs(parent, exist_ok=True)
            os.replace(staging, out)
        _log(f"bundle {bundle_id[:12]} -> {out}")
        return out
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise


# ---------------------------------------------------------------------------
# Loading / booting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WarmStartBundle:
    """A loaded bundle: the manifest plus the on-disk root directory.

    ``load`` -> ``verify`` -> ``install_tunings`` + ``install_plans`` +
    ``install_libraries``
    -> ``boot(scheduler)`` is the replica boot sequence
    (``boot_scheduler`` runs all of it).
    Every step refuses with a ``BundleError`` naming the mismatched
    field rather than falling back to building.
    """

    root: str
    manifest: dict

    @classmethod
    def load(cls, path: str) -> "WarmStartBundle":
        """Load a bundle directory or ``.tar`` archive (extracted to a
        temp directory that lives as long as the process)."""
        if not os.path.exists(path):
            raise BundleError(f"bundle path {path!r} does not exist")
        root = path
        if os.path.isfile(path):
            root = tempfile.mkdtemp(prefix="fcn3-bundle-")
            with tarfile.open(path) as tf:
                try:
                    tf.extractall(root, filter="data")
                except TypeError:  # Python without the filter= parameter
                    tf.extractall(root)
        mpath = os.path.join(root, "manifest.json")
        if not os.path.exists(mpath):
            raise BundleError(f"{path!r} has no manifest.json -- not a "
                              f"warm-start bundle")
        with open(mpath) as f:
            manifest = json.load(f)
        fmt = manifest.get("format")
        if fmt != BUNDLE_FORMAT:
            raise BundleError(
                f"bundle format {fmt!r} is not supported (expected "
                f"{BUNDLE_FORMAT!r}); rebuild the bundle with this "
                f"version of the code")
        return cls(root=root, manifest=manifest)

    # -- identity ------------------------------------------------------
    @property
    def bundle_id(self) -> str:
        """Content address: sha256 of the canonical manifest."""
        return self.manifest.get("bundle_id", "")

    @property
    def blobs_dir(self) -> str:
        """Directory holding the ``lib<name>-<sha>.so`` kernel libraries."""
        return os.path.join(self.root, "blobs")

    def specs(self) -> list[RequestSpec]:
        """The request shapes this bundle pre-warms."""
        return [RequestSpec.from_dict(e["spec"])
                for e in self.manifest.get("engines", [])]

    # -- verification --------------------------------------------------
    def verify(self, deep: bool = True, device="cuda") -> None:
        """Refuse (BundleError) unless this process can serve the bundle
        on ``device`` without building anything.

        Checks, in order: the content address (manifest integrity), that
        every packed tuning's winning library and every listed library is
        a packed file, the strict environment fields (torch and CUDA
        versions, the device, the ``repro_torch`` source fingerprint --
        each one invalidates the libraries or the key tokens), and with
        ``deep=True`` the sha256 of every packed file (a tampered or
        truncated file is refused here, not discovered mid-boot).  Every
        failure is reported, not just the first.
        """
        problems: list[str] = []
        want_id = hashlib.sha256(_canonical(self.manifest)).hexdigest()
        if want_id != self.bundle_id:
            problems.append(
                f"manifest does not match its content address: "
                f"bundle_id={self.bundle_id!r} but canonical manifest "
                f"hashes to {want_id!r} (manifest edited after build?)")
        files = self.manifest.get("files", {})
        for rel in self.manifest.get("tunings", []):
            try:
                with open(os.path.join(self.root, rel)) as f:
                    entry = json.load(f)
                lib = f"blobs/{entry['library']}"
                what = f"{entry['op']} at {entry['shapes']}"
            except (OSError, ValueError, TypeError, KeyError) as e:
                problems.append(f"tuning {rel!r} is unreadable "
                                f"({type(e).__name__}: {e})")
                continue
            if lib not in files or not os.path.exists(
                    os.path.join(self.root, lib)):
                problems.append(
                    f"tuning {rel!r} ({what}) launches {lib!r}, which the "
                    f"bundle does not pack")
        for lib in self.manifest.get("libraries", []):
            if lib["file"] not in files:
                problems.append(f"library {lib['file']!r} is listed but "
                                f"not packed")
        env_here = environment(device)
        env_bundle = self.manifest.get("environment", {})
        for field in _STRICT_ENV:
            if env_bundle.get(field) != env_here.get(field):
                problems.append(
                    f"environment mismatch on {field!r}: bundle has "
                    f"{env_bundle.get(field)!r}, this process has "
                    f"{env_here.get(field)!r}")
        if deep:
            for rel, meta in sorted(self.manifest.get("files", {}).items()):
                path = os.path.join(self.root, rel)
                if not os.path.exists(path):
                    problems.append(f"missing bundle file {rel!r}")
                    continue
                got = _sha256_file(path)
                if got != meta["sha256"]:
                    problems.append(
                        f"sha256 mismatch for {rel!r}: manifest says "
                        f"{meta['sha256']}, file hashes to {got} "
                        f"(corrupt or tampered)")
        if problems:
            raise BundleError(
                "refusing to boot from bundle "
                f"{self.bundle_id[:12] or '<no id>'}: "
                + "; ".join(problems))

    # -- installation --------------------------------------------------
    def install_plans(self) -> int:
        """Install the packed geometry plans (DISCO psi + banded splits,
        Legendre tables) into the process-wide plan caches; returns how
        many were installed."""
        n = 0
        for rel in self.manifest.get("plans", []):
            _install_plan_payload(_load_plan_npz(
                os.path.join(self.root, rel)))
            n += 1
        return n

    def install_tunings(self) -> int:
        """Install the packed kernel tunings as the process-active
        ``TuningCache`` (``kernels.autotune``), so every engine key this
        replica derives resolves the tiles the bundle's engines were
        warmed with -- with no sweep.  A bundle without tunings
        uninstalls any active cache (its libraries are the committed
        tiles; a leftover cache would derive other keys).  Returns the
        entry count."""
        from repro_torch.kernels import autotune
        packed = self.manifest.get("tunings", [])
        autotune.install_tuning_cache(
            os.path.join(self.root, "tunings") if packed else None)
        return len(packed)

    def install_libraries(self, cache) -> int:
        """Load the packed kernel libraries (``blobs/``; the manifest's
        ``libraries`` gives each file's source and defines) through ``cache``
        (the replica's readonly cache over ``blobs/``), so that whatever
        launches a kernel next -- the model's calibration included --
        runs them and never ``nvcc``.  Returns how many were loaded; a
        library built from other sources than this checkout's, or one
        that will not load, is refused."""
        from repro_torch.kernels import build
        listed = {lib["file"]: (lib["name"],
                                tuple(tuple(d) for d in lib["defines"]))
                  for lib in self.manifest.get("libraries", [])}
        libs = []
        for rel in sorted(self.manifest.get("files", {})):
            base = rel.rpartition("/")[2]
            if rel.startswith("blobs/lib") and base.endswith(".so"):
                # a file the list does not name is a committed library
                libs.append(listed.get(
                    rel, (base[len("lib"):].rpartition("-")[0], ())))
        try:
            return cache.load_libraries(libs)
        except ReadOnlyCacheMiss as e:
            raise BundleError(
                f"bundle {self.bundle_id[:12]} cannot load its kernel "
                f"libraries {[build.label(*lib) for lib in libs]}: "
                f"{e}") from e

    def boot(self, scheduler) -> dict:
        """Pre-warm ``scheduler`` with every engine in the manifest.

        Every key must be warmed from the bundle ("disk") or already be
        warm ("memory"); anything else -- including a
        ``ReadOnlyCacheMiss`` from the readonly cache -- is a refusal.
        Returns the ``bundle`` stats block the scheduler reports
        (bundle id, engines/programs warmed, disk hits, boot seconds).
        """
        t0 = time.perf_counter()
        programs = 0
        disk_hits = 0
        for entry in self.manifest.get("engines", []):
            spec = RequestSpec.from_dict(entry["spec"])
            for prog in entry["programs"]:
                try:
                    out = scheduler.warmup(spec, batch=prog["batch"])
                except ReadOnlyCacheMiss as e:
                    raise BundleError(
                        f"bundle {self.bundle_id[:12]} cannot serve "
                        f"spec {entry['spec']} "
                        f"(batch={prog['batch']}): {e}") from e
                for o in out["outcomes"]:
                    if o["source"] not in ("disk", "memory"):
                        raise BundleError(
                            f"chunk_len={o['chunk_len']} for spec "
                            f"{entry['spec']} was {o['source']!r}, not "
                            f"served from the bundle -- refusing a "
                            f"silently-building boot")
                    programs += 1
                    disk_hits += o["source"] == "disk"
        info = {
            "bundle_id": self.bundle_id,
            "path": self.root,
            "engines": len(self.manifest.get("engines", [])),
            "programs": programs,
            "disk_hits": disk_hits,
            "boot_s": round(time.perf_counter() - t0, 3),
        }
        if hasattr(scheduler, "set_bundle_info"):
            scheduler.set_bundle_info(info)
        return info


def boot_scheduler(bundle: "WarmStartBundle | str", pool=None,
                   device="cuda", **scheduler_kwargs):
    """One-call replica boot: verify, install the tunings and the plans
    and load the kernel libraries (on a card), build a scheduler over a
    readonly cache of the bundle's libraries and pre-warm every bundled
    engine.  Returns the ready scheduler.

    ``bundle`` may be a loaded ``WarmStartBundle`` or a path; the
    replica runs on ``pool``'s device (a new ``ModelPool(device=device)``
    when ``pool`` is None).  The scheduler's cache is
    ``ExecutableCache(blobs_dir, readonly=True)``: a request that would
    need ``nvcc`` or a plan the bundle lacks raises ``ReadOnlyCacheMiss``
    instead of building.  The ``bundle`` stats block also carries the
    plans installed, ``plans_install_s`` and the libraries loaded.
    """
    if isinstance(bundle, str):
        bundle = WarmStartBundle.load(bundle)
    from repro_torch.serving.cache import ExecutableCache
    from repro_torch.serving.scheduler import ForecastScheduler, ModelPool
    if pool is None:
        pool = ModelPool(device=device)
    bundle.verify(device=pool.device)
    tunings = bundle.install_tunings()
    t0 = time.perf_counter()
    plans = bundle.install_plans()
    plans_install_s = time.perf_counter() - t0
    scheduler = ForecastScheduler(
        pool=pool,
        cache=ExecutableCache(persist_dir=bundle.blobs_dir, readonly=True),
        **scheduler_kwargs)
    try:
        # a replica on the CPU launches no kernel: it loads none
        libraries = (bundle.install_libraries(scheduler.cache)
                     if pool.device.type == "cuda" else 0)
        info = bundle.boot(scheduler)
    except BaseException:
        scheduler.close()
        raise
    scheduler.set_bundle_info({**info, "plans": plans,
                               "plans_install_s": round(plans_install_s, 3),
                               "libraries": libraries, "tunings": tunings})
    return scheduler
