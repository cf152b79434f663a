"""Build a CUDA source of ``csrc/`` into a shared library at first use.

The library has a plain C interface and is loaded with ctypes.  It is
compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the root
of the checkout (git-ignored), under a name keyed by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Builds of different sources may run in parallel
threads.  Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_path_locks: dict[Path, threading.Lock] = {}
_loaded: dict[Path, "BuiltLibrary"] = {}


@dataclass
class BuiltLibrary:
    """A loaded library and what its build printed (empty when loaded
    from an earlier build)."""

    lib: ctypes.CDLL
    path: Path
    log: str
    seconds: float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels "
        "are built from source at first use and need the CUDA toolkit"
    )


def build_library(name: str, source: Path) -> BuiltLibrary:
    """Compile ``source`` (once per content) and load it."""
    src = source.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"lib{name}_{key}.so"
    # one lock per library: different sources build in parallel threads
    with _lock:
        path_lock = _path_locks.setdefault(path, threading.Lock())
    with path_lock:
        if path in _loaded:
            return _loaded[path]
        t0 = time.perf_counter()
        log = ""
        if not path.exists():
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {source}:\n"
                    f"{' '.join(cmd)}\n{log}"
                )
            os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
        built = BuiltLibrary(
            ctypes.CDLL(str(path)), path, log, time.perf_counter() - t0
        )
        _loaded[path] = built
        return built
