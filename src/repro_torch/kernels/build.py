"""Build the port's CUDA sources into plain-C shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch/lib<name>-<sha>.so <name>.cu

and loaded with ``ctypes``.  The library name carries a hash of the
source and of the shared headers (``csrc/*.cuh``), so an edited source
is rebuilt and a stale library never loads.

A library may also be a *variant*: the same source built with ``-D``
flags that override its tile constants (``#define TUNE_<NAME>`` in each
source; ``kernels.config.BlockConfig.defines`` makes them).  A library
is named by its source and its defines, ``(name, defines)`` with
``defines`` a tuple of ``(macro, int)`` pairs; the sorted defines enter
its hash, and with no defines the name is the committed kernel's, as it
always was.  Each source exports ``<name>_constants`` (its compiled
tile), which ``constants`` reads, so a wrapper takes its grid limits
from the library it launches and keeps no copy of its own.

``build_all`` starts one ``nvcc`` per library at once and waits for all
of them.  A failed build raises; nothing falls back to a plain version
or to the committed tile.

A library can also be loaded from another directory that holds it under
the same content-addressed name (``load_library_from``: the serving
cache's persist directory, a warm-start bundle's ``blobs/``); a file
built from other sources has another name and is never loaded.
``nvcc_runs`` counts the compiler processes this process started.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: ``<checkout>/build/repro_torch`` (``build/`` is git-ignored).
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("legendre", "disco_band", "disco_band_bwd", "crps", "ssd",
           "ssd_state", "ssd_bwd", "ssd_state_bwd")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_libs: dict[tuple, ctypes.CDLL] = {}
_constants: dict[tuple, dict[str, int]] = {}
#: ``nvcc -Xptxas -v`` output of each build (registers, shared memory),
#: by ``(name, defines)``.
build_logs: dict[tuple, str] = {}
#: ``nvcc`` processes started by this process (a plain integer).
nvcc_runs = 0
_MACRO = re.compile(r"[A-Z_][A-Z0-9_]*\Z")


def nvcc_path() -> str:
    """Path of ``nvcc``: on PATH, under CUDA_HOME or /usr/local/cuda."""
    cand = shutil.which("nvcc")
    if cand:
        return cand
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def normalize_defines(defines=()) -> tuple[tuple[str, int], ...]:
    """``defines`` as a sorted tuple of ``(macro, int)`` pairs; refuses a
    name that is not a C macro name, a repeated name or a value that is
    not an integer."""
    out = []
    for macro, value in defines:
        if not isinstance(macro, str) or not _MACRO.match(macro):
            raise ValueError(f"not a macro name: {macro!r}")
        if isinstance(value, bool) or not isinstance(value, int):
            raise ValueError(f"-D{macro}: {value!r} is not an integer")
        out.append((macro, int(value)))
    out.sort()
    if len({m for m, _ in out}) != len(out):
        raise ValueError(f"a macro is defined twice in {defines!r}")
    return tuple(out)


def library_key(item) -> tuple[str, tuple]:
    """``(name, defines)`` of ``item``, a source name or such a pair, the
    defines normalized: how this module keys a library."""
    name, defines = (item, ()) if isinstance(item, str) else item
    return name, normalize_defines(defines)


def library_file(name: str, defines=()) -> str:
    """``lib<name>-<sha>.so``: the library's file name, addressed by the
    hash of ``<name>.cu``, of the shared headers and of the sorted
    ``defines`` (none: the committed kernel's name)."""
    sha = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        sha.update(header.read_bytes())
    defines = normalize_defines(defines)
    if defines:
        sha.update(" ".join(f"-D{m}={v}" for m, v in defines).encode())
    return f"lib{name}-{sha.hexdigest()[:12]}.so"


def label(name: str, defines=()) -> str:
    """``name``, or ``name[MACRO=v,...]`` for a variant (log lines)."""
    defines = normalize_defines(defines)
    return name + (f"[{','.join(f'{m}={v}' for m, v in defines)}]"
                   if defines else "")


def _target(name: str, defines=()) -> Path:
    return BUILD_DIR / library_file(name, defines)


def library_path(name: str, defines=()) -> Path:
    """The file of the loaded library, else where ``build_all`` puts it
    (which may not exist yet)."""
    key = library_key((name, defines))
    with _lock:
        lib = _libs.get(key)
    return Path(lib._name) if lib is not None else _target(*key)


def _command(name: str, out: Path, defines=()) -> list[str]:
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
            *(f"-D{m}={v}" for m, v in normalize_defines(defines)),
            "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(libraries=SOURCES) -> None:
    """Compile every missing library, one ``nvcc`` per library in
    parallel; ``libraries`` holds source names and ``(name, defines)``
    pairs.  Raises, naming each library whose build failed."""
    global nvcc_runs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key in dict.fromkeys(library_key(item) for item in libraries):
        out = _target(*key)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        nvcc_runs += 1
        procs[key] = (tmp, out, subprocess.Popen(
            _command(key[0], tmp, key[1]), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    errors = []
    for key, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[key] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {label(*key)} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def load_library(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` built with ``defines``,
    built on first use."""
    key = library_key((name, defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build_all((key,))
            lib = ctypes.CDLL(str(_target(*key)))
            _libs[key] = lib
        return lib


def is_loaded(name: str, defines=()) -> bool:
    """Whether this process has the library of ``(name, defines)``
    loaded."""
    key = library_key((name, defines))
    with _lock:
        return key in _libs


def load_library_from(name: str, directory: str | os.PathLike,
                      defines=()) -> ctypes.CDLL:
    """Load ``<directory>/lib<name>-<sha>.so`` for the current sources and
    ``defines``, never building; raises ``FileNotFoundError`` when the
    directory has no such library (one built from other sources or other
    defines has another hash in its name).  A library already loaded
    stays the one used."""
    key = library_key((name, defines))
    path = Path(directory) / library_file(*key)
    if not path.is_file():
        stale = sorted(p.name for p in Path(directory).glob(f"lib{name}-*.so"))
        raise FileNotFoundError(
            f"no {path.name} ({label(*key)}) in {directory}"
            + (f" (found {stale}: built from other sources or defines)"
               if stale else ""))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            _libs[key] = lib
        return lib


def constants(name: str, defines, fields: tuple[str, ...]) -> dict[str, int]:
    """The compiled constants the library of ``(name, defines)`` exports
    through ``int <name>_constants(int* out)``, by ``fields`` (in the
    source's order); loads the library (building it on first use) and
    reads it once per process."""
    key = library_key((name, defines))
    with _lock:
        got = _constants.get(key)
    if got is None:
        fn = getattr(load_library(*key), f"{name}_constants")
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        buf = (ctypes.c_int * 32)()
        n = fn(ctypes.addressof(buf))
        if n != len(fields):
            raise RuntimeError(f"{label(*key)} exports {n} constants, the "
                               f"wrapper expects {len(fields)} {fields}")
        got = dict(zip(fields, buf[:n]))
        with _lock:
            _constants[key] = got
    return got


def reset_registry() -> None:
    """Forget which libraries are loaded, so that the next load resolves
    each one again (from the build directory or ``load_library_from``'s).
    Libraries already loaded stay mapped in the process."""
    with _lock:
        _libs.clear()


def check_launch(err: int, what: str) -> None:
    """Raise when a C launcher returned a non-zero ``cudaGetLastError``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
