"""Build the port's CUDA sources into plain-C shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch/lib<name>-<sha>.so <name>.cu

and loaded with ``ctypes``.  The library name carries a hash of the
source and of the shared headers (``csrc/*.cuh``), so an edited source
is rebuilt and a stale library never loads.
``build_all`` starts one ``nvcc`` per source at once and waits for all of
them.  A failed build raises; nothing falls back to a plain version.

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
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: ``<checkout>/build/repro_torch`` (``build/`` is git-ignored).
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("legendre", "disco_band", "disco_band_bwd", "crps", "ssd",
           "ssd_state")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: ``nvcc -Xptxas -v`` output of each build (registers, shared memory).
build_logs: dict[str, str] = {}
#: ``nvcc`` processes started by this process (a plain integer).
nvcc_runs = 0


def nvcc_path() -> str:
    """Path of ``nvcc``: on PATH, under CUDA_HOME or /usr/local/cuda."""
    cand = shutil.which("nvcc")
    if cand:
        return cand
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_file(name: str) -> str:
    """``lib<name>-<sha>.so``: the library's file name, addressed by the
    hash of ``<name>.cu`` and of the shared headers."""
    sha = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        sha.update(header.read_bytes())
    return f"lib{name}-{sha.hexdigest()[:12]}.so"


def _target(name: str) -> Path:
    return BUILD_DIR / library_file(name)


def library_path(name: str) -> Path:
    """The file of the loaded library, else where ``build_all`` puts it
    (which may not exist yet)."""
    with _lock:
        lib = _libs.get(name)
    return Path(lib._name) if lib is not None else _target(name)


def _command(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
            "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: tuple[str, ...] = SOURCES) -> None:
    """Compile every missing library, one ``nvcc`` per source in parallel."""
    global nvcc_runs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        nvcc_runs += 1
        procs[name] = (tmp, out, subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def is_loaded(name: str) -> bool:
    """Whether this process has the library for ``csrc/<name>.cu`` loaded."""
    with _lock:
        return name in _libs


def load_library_from(name: str, directory: str | os.PathLike
                      ) -> ctypes.CDLL:
    """Load ``<directory>/lib<name>-<sha>.so`` for the current sources,
    never building; raises ``FileNotFoundError`` when the directory has no
    library of these sources (one built from other sources has another
    hash in its name).  A library already loaded stays the one used."""
    path = Path(directory) / library_file(name)
    if not path.is_file():
        stale = sorted(p.name for p in Path(directory).glob(f"lib{name}-*.so"))
        raise FileNotFoundError(
            f"no {path.name} in {directory}"
            + (f" (found {stale}: built from other sources)" if stale else ""))
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


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
