"""Warm-key cache of the forecast service: the counterpart of the JAX
package's AOT executable cache (``repro.serving.cache``).

The port compiles no chunk program, so there is no executable to lower,
export or import.  What a key needs before its first rollout is:

* the kernel libraries its path launches (``ForecastEngine.
  kernel_libraries``: the Legendre kernel and the band contraction on
  the card, each at the tile its ``KernelConfig.blocks`` names -- a
  tuned tile is a variant library, ``(name, defines)``; none on the
  CPU), each loaded once per process and built by ``nvcc`` on a miss
  (``kernels.build``);
* the engine's resident inputs (``ForecastEngine.make_resident``): the
  geometry buffers in the engine's layout, the bf16 copies under the bf16
  policy and the spectra's table.

Warming a key does both and never runs a rollout.  The wire keeps the
reference's names: ``compile_s`` is the seconds a warm took (kernel
builds or loads, geometry and buffer set-up), a **miss** (source
``"compiled"``) is a warm that had to produce an artifact -- a library
absent from ``persist_dir`` (built now, or taken from the build
directory and persisted), or any warm when nothing is persisted -- and a
**disk hit** (source ``"disk"``) a warm served from ``persist_dir``
alone.  A warm key is a **hit** (source ``"memory"``, ``compile_s``
0.0).

With ``persist_dir`` the "executables" persisted are the kernel
libraries themselves, under their content-addressed names
(``lib<name>-<sha>.so``, the hash of the sources and of a variant's
defines in the name), so a
fresh process loads them instead of running ``nvcc``.  ``readonly=True``
(a replica booted from a warm-start bundle) raises ``ReadOnlyCacheMiss``
wherever it would otherwise run ``nvcc`` or build a geometry plan
(``require_plans``): a key is servable from a bundle when its libraries
and its config's plans are in it.

Keys follow the reference's fields: ``(config, chunk_len, scored, the
whole EngineConfig, batch)``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import shutil
import threading
import time
from pathlib import Path

from repro_torch.serving import faults as faultlib

_log = logging.getLogger("repro_torch.serving.cache")

_CODE_FINGERPRINT: str | None = None


def _code_fingerprint() -> str:
    """sha1 over every ``repro_torch`` source file -- the Python modules
    and the CUDA sources under ``csrc/`` -- computed once per process.

    A math-only edit keeps every shape in a key identical; hashing the
    package's sources over-invalidates (any edit changes the token),
    which is the cheap, safe side of that trade.
    """
    global _CODE_FINGERPRINT
    if _CODE_FINGERPRINT is None:
        root = Path(__file__).resolve().parents[1]
        h = hashlib.sha1()
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            for name in sorted(filenames):
                if name.endswith((".py", ".cu", ".cuh")):
                    path = os.path.join(dirpath, name)
                    h.update(os.path.relpath(path, root).encode("utf-8"))
                    with open(path, "rb") as f:
                        h.update(f.read())
        _CODE_FINGERPRINT = h.hexdigest()
    return _CODE_FINGERPRINT


def platform(device=None) -> str:
    """The device a key's artifacts are for: ``cuda:<name>:sm<cc>`` of
    ``device`` (the current CUDA device when None and one is usable),
    else ``cpu``."""
    import torch
    dev = torch.device("cuda" if device is None and torch.cuda.is_available()
                       else device or "cpu")
    if dev.type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        return "cuda:unavailable"
    major, minor = torch.cuda.get_device_capability(dev)
    return f"cuda:{torch.cuda.get_device_name(dev)}:sm{major}{minor}"


def environment(device=None) -> dict:
    """What a key's artifacts are scoped by: the torch and CUDA versions,
    the device (``platform``) and the port's source fingerprint."""
    import torch
    return {"torch": torch.__version__,
            "cuda": torch.version.cuda or "none",
            "device": platform(device),
            "source_fingerprint": _code_fingerprint()}


@dataclasses.dataclass(frozen=True)
class ExecutableKey:
    """Identity of one warm chunk key.

    ``engine`` is the *entire* ``EngineConfig`` as a nested tuple, so a
    future engine knob can never be silently missing from the key.
    """

    config: str
    chunk_len: int
    scored: bool
    engine: tuple
    #: coalesced-request batch size; None selects the serial rollout
    batch: int | None = None

    @classmethod
    def for_engine(cls, config: str, engine, scored: bool,
                   chunk_len: int, batch: int | None = None
                   ) -> "ExecutableKey":
        """The key for one chunk length of a live ``ForecastEngine``."""
        return cls(config=config, chunk_len=chunk_len, scored=scored,
                   engine=dataclasses.astuple(engine.cfg), batch=batch)

    def token(self, device=None) -> str:
        """Stable name of the key, scoped by ``environment(device)``
        (torch and CUDA versions, the device, the source fingerprint)."""
        env = environment(device)
        tag = f"{self!r}|" + "|".join(f"{k}={env[k]}" for k in sorted(env))
        return hashlib.sha1(tag.encode("utf-8")).hexdigest()[:16]


class ReadOnlyCacheMiss(RuntimeError):
    """A readonly cache was asked for something it would have to build.

    Raised instead of running ``nvcc`` or building a geometry plan: a
    replica booted from a warm-start bundle (``repro_torch.serving.
    bundle``) must refuse -- naming the key and what it looked for --
    rather than silently pay the build the bundle exists to eliminate.
    """


class ExecutableCache:
    """Thread-safe warm/hit/miss bookkeeping over the engines' serving
    hooks.

    Warming is serialized **per key** -- two requests racing on the same
    key set it up once, while a cold warm for one key never blocks a hit
    (or a warm) for another.  The global lock is only held for lookups
    and stats updates.

    ``readonly=True`` (bundle-boot mode) turns every would-be build into
    a ``ReadOnlyCacheMiss``: libraries come from memory or an existing
    ``persist_dir`` file, nothing is ever written, and a library that
    fails to load raises instead of being quarantined and rebuilt.
    """

    def __init__(self, persist_dir: str | None = None,
                 readonly: bool = False):
        if readonly and not persist_dir:
            raise ValueError("readonly cache needs a persist_dir to "
                             "serve libraries from")
        self.persist_dir = persist_dir
        self.readonly = readonly
        if persist_dir and not readonly:
            os.makedirs(persist_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._key_locks: dict[ExecutableKey, threading.Lock] = {}
        self._known: set[ExecutableKey] = set()
        self._faults = faultlib.NULL_FAULTS
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0
        self.quarantined = 0
        self.compile_s = 0.0

    def bind_faults(self, injector) -> None:
        """Route this cache's fault points (``compile``, ``cache_read``,
        ``cache_write``, ``import_chunk``) through ``injector``."""
        self._faults = injector

    def _path(self, lib: tuple[str, tuple]) -> str | None:
        from repro_torch.kernels import build
        if not self.persist_dir:
            return None
        return os.path.join(self.persist_dir, build.library_file(*lib))

    def require_plans(self, config: str) -> None:
        """On a readonly cache, raise ``ReadOnlyCacheMiss`` unless every
        geometry plan a model of ``config`` needs (its DISCO plans and
        Legendre tables) was installed from a bundle -- before anything
        builds one.  A no-op on a writable cache."""
        if not self.readonly:
            return
        from repro_torch.configs import fcn3 as fcn3cfg
        from repro_torch.core import fcn3
        from repro_torch.core.sphere import disco as discolib
        from repro_torch.core.sphere import legendre as leg
        installed = {"disco": discolib.is_installed,
                     "legendre": leg.is_installed}
        missing = [kind for kind, key in fcn3.geometry_keys(
            fcn3cfg.NAMED_CONFIGS[config]()) if not installed[kind](key)]
        if missing:
            raise ReadOnlyCacheMiss(
                f"config {config!r} needs {len(missing)} geometry plan(s) "
                f"({', '.join(missing)}) the bundle did not install; "
                f"refusing to build them -- the bundle was not built for "
                f"this config")

    def load_libraries(self, libs) -> int:
        """Load the libraries (names or ``(name, defines)`` pairs) from
        ``persist_dir`` now (through the
        ``cache_read`` and ``import_chunk`` fault points), before anything
        launches a kernel: a replica booting from a bundle does so, so
        that its model's calibration runs the bundled libraries and never
        ``nvcc``.  Returns how many were loaded; on a readonly cache a
        library that is missing or will not load raises
        ``ReadOnlyCacheMiss``."""
        from repro_torch.kernels import build
        n = 0
        for lib in map(build.library_key, libs):
            if build.is_loaded(*lib):
                continue
            path = self._path(lib)
            if path is None or not os.path.exists(path):
                if self.readonly:
                    raise ReadOnlyCacheMiss(
                        f"no {build.library_file(*lib)} ({build.label(*lib)})"
                        f" in {self.persist_dir}; refusing to run nvcc")
                continue
            n += self._from_disk(None, lib, path)
        return n

    def _from_disk(self, key: ExecutableKey | None, lib: tuple[str, tuple],
                   path: str) -> bool:
        """Try loading a persisted library.

        Two failure modes, handled differently: a *read* failure (the
        file cannot be read) leaves the file alone -- the disk may merely
        be flaky, and the rebuild writes a fresh copy over it.  A *load*
        failure (the bytes are there but the dynamic loader rejects them)
        **quarantines** the file -- renamed to ``*.corrupt`` and counted
        -- so a corrupt file fails at most once.  Both fall back to
        building.  A readonly cache instead raises ``ReadOnlyCacheMiss``
        on either: the file came from a bundle and must not be renamed or
        silently rebuilt around.
        """
        from repro_torch.kernels import build
        of = f" for key {key!r}" if key is not None else ""
        try:
            self._faults.fire("cache_read", path=path)
            with open(path, "rb") as f:
                f.read(1)
        except (OSError, faultlib.InjectedFault) as e:
            if self.readonly:
                raise ReadOnlyCacheMiss(
                    f"bundle library {path}{of} failed to "
                    f"read ({type(e).__name__}: {e}); refusing to rebuild "
                    f"-- the bundle does not match this process") from e
            _log.warning("failed to read library %s (%s: %s); rebuilding",
                         path, type(e).__name__, e)
            return False
        try:
            self._faults.fire("import_chunk", path=path)
            build.load_library_from(lib[0], self.persist_dir, lib[1])
            return True
        except (OSError, faultlib.InjectedFault) as e:
            if self.readonly:
                raise ReadOnlyCacheMiss(
                    f"bundle library {path}{of} failed to "
                    f"load ({type(e).__name__}: {e}); refusing to rebuild "
                    f"-- the bundle does not match this process") from e
            qpath = path + ".corrupt"
            try:
                os.replace(path, qpath)
            except OSError:
                qpath = "<unlinked>"
            with self._lock:
                self.quarantined += 1
            _log.warning("quarantined unloadable library %s -> %s (%s: %s);"
                         " rebuilding", path, qpath, type(e).__name__, e)
            return False

    def _persist(self, lib: tuple[str, tuple], path: str) -> None:
        """Copy a built library into ``persist_dir`` (atomic rename)."""
        from repro_torch.kernels import build
        self._faults.fire("cache_write", path=path)
        tmp = f"{path}.tmp.{os.getpid()}"
        shutil.copyfile(build.library_path(*lib), tmp)
        os.replace(tmp, path)

    def _installed(self, key: ExecutableKey, engine, buffers) -> bool:
        return engine.is_warm(key.scored, key.chunk_len, buffers,
                              batch=key.batch)

    def warm(self, key: ExecutableKey, engine, buffers) -> dict:
        """Warm ``key`` on ``engine``: its kernel libraries loaded, its
        inputs resident for ``buffers``.

        Returns ``{"hit", "source", "compile_s"}`` where source is
        "memory" (already warm), "disk" (set up from ``persist_dir``
        alone) or "compiled" (a library had to be produced, or nothing is
        persisted).
        """
        from repro_torch.kernels import build
        with self._lock:
            if self._installed(key, engine, buffers):
                self.hits += 1
                return {"hit": True, "source": "memory", "compile_s": 0.0}
            key_lock = self._key_locks.setdefault(key, threading.Lock())
        with key_lock:
            # another request may have warmed this key while we waited
            if self._installed(key, engine, buffers):
                with self._lock:
                    self.hits += 1
                return {"hit": True, "source": "memory", "compile_s": 0.0}
            t0 = time.perf_counter()
            # the libraries this warm must produce: absent from
            # persist_dir (or unreadable there), or, with nothing
            # persisted, not loaded yet
            produce = []
            for lib in map(build.library_key, engine.kernel_libraries()):
                path = self._path(lib)
                if path is None:
                    if not build.is_loaded(*lib):
                        produce.append(lib)
                elif not os.path.exists(path) or (
                        not build.is_loaded(*lib)
                        and not self._from_disk(key, lib, path)):
                    produce.append(lib)
            compiled = bool(produce) or not self.persist_dir
            if produce and self.readonly:
                raise ReadOnlyCacheMiss(
                    f"no bundle library for "
                    f"{[build.label(*lib) for lib in produce]} (key "
                    f"{key!r}; looked in {self.persist_dir} for "
                    f"{[build.library_file(*lib) for lib in produce]}); "
                    f"refusing "
                    f"to run nvcc -- the bundle was not built from these "
                    f"sources")
            if compiled:
                self._faults.fire("compile", key=str(key.chunk_len))
            for lib in produce:
                build.load_library(*lib)     # nvcc when not built yet
                if self.persist_dir:
                    self._persist(lib, self._path(lib))
            engine.make_resident(buffers)
            engine.mark_warm(key.scored, key.chunk_len, batch=key.batch)
            dt = time.perf_counter() - t0
            with self._lock:
                self.compile_s += dt
                self._known.add(key)
                if compiled:
                    self.misses += 1
                else:
                    self.disk_hits += 1
            if compiled:
                return {"hit": False, "source": "compiled", "compile_s": dt}
            return {"hit": True, "source": "disk", "compile_s": dt}

    def warm_engine(self, config: str, engine, scored: bool, steps: int,
                    buffers, batch: int | None = None) -> dict:
        """Warm every chunk length a ``steps``-long rollout runs (the
        coalesced ``batch``-request keys when ``batch`` is set).

        Returns the per-request summary the scheduler reports: total
        ``compile_s`` plus one outcome entry per distinct chunk length.
        """
        outcomes = []
        for k in engine.chunk_lengths(steps):
            key = ExecutableKey.for_engine(config, engine, scored, k,
                                           batch=batch)
            out = self.warm(key, engine, buffers)
            outcomes.append({"chunk_len": k, **out})
        return {
            "compile_s": sum(o["compile_s"] for o in outcomes),
            "hits": sum(1 for o in outcomes if o["hit"]),
            "misses": sum(1 for o in outcomes if not o["hit"]),
            "outcomes": outcomes,
        }

    def stats(self) -> dict:
        """Counters snapshot: distinct keys seen, hit/miss/disk-hit
        totals, cumulative warm seconds and the persistence config."""
        with self._lock:
            return {"keys": len(self._known), "hits": self.hits,
                    "misses": self.misses, "disk_hits": self.disk_hits,
                    "quarantined": self.quarantined,
                    "compile_s": self.compile_s,
                    "persist_dir": self.persist_dir,
                    "readonly": self.readonly}

    def bind_metrics(self, registry) -> None:
        """Export the cache's live counters into a ``MetricsRegistry``:
        a collector callback reads the same tallies ``stats()`` reports
        at every ``/metrics`` scrape, so the two views agree exactly."""
        from repro_torch.serving.observability import METRIC_PREFIX as p

        def collect():
            s = self.stats()
            return [
                {"name": p + "cache_hits_total", "type": "counter",
                 "help": "Warm-key memory hits",
                 "samples": [({}, s["hits"])]},
                {"name": p + "cache_misses_total", "type": "counter",
                 "help": "Key warms that built an artifact (cache misses)",
                 "samples": [({}, s["misses"])]},
                {"name": p + "cache_disk_hits_total", "type": "counter",
                 "help": "Key warms served from persisted libraries",
                 "samples": [({}, s["disk_hits"])]},
                {"name": p + "cache_compile_seconds_total",
                 "type": "counter",
                 "help": "Cumulative key warm-up seconds",
                 "samples": [({}, s["compile_s"])]},
                {"name": p + "cache_quarantined_total", "type": "counter",
                 "help": "Unloadable persisted libraries quarantined",
                 "samples": [({}, s["quarantined"])]},
                {"name": p + "cache_keys", "type": "gauge",
                 "help": "Distinct warm keys seen",
                 "samples": [({}, s["keys"])]},
            ]

        registry.register_collector(collect)
