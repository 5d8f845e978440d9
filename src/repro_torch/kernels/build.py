"""Build the port's CUDA sources into plain-C shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch/lib<name>-<sha>.so <name>.cu

and loaded with ``ctypes``.  The library name carries a hash of the
source and of the shared headers (``csrc/*.cuh``), so an edited source
is rebuilt and a stale library never loads.
``build_all`` starts one ``nvcc`` per source at once and waits for all of
them.  A failed build raises; nothing falls back to a plain version.
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


def nvcc_path() -> str:
    """Path of ``nvcc``: on PATH, under CUDA_HOME or /usr/local/cuda."""
    cand = shutil.which("nvcc")
    if cand:
        return cand
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    sha = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        sha.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{sha.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
            "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: tuple[str, ...] = SOURCES) -> None:
    """Compile every missing library, one ``nvcc`` per source in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
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


def check_launch(err: int, what: str) -> None:
    """Raise when a C launcher returned a non-zero ``cudaGetLastError``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
