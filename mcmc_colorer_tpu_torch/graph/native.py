"""ctypes binding of the C++ hash-graph enumerator (``native/importer.cpp``).

Counterpart of ``graph/native.py:generate_er_hash``.  The library
``native/build/libmcgraph.so`` is git-ignored, so it is built with
``make -C native`` at first use; a failed build raises (there is no
Python fallback on this path).
"""

from __future__ import annotations

import ctypes
import fcntl
import subprocess
import threading
from pathlib import Path

import numpy as np

from mcmc_colorer_tpu_torch.graph.container import Graph

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_SO_PATH = _NATIVE_DIR / "build" / "libmcgraph.so"

_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        _SO_PATH.parent.mkdir(exist_ok=True)
        # the file lock keeps concurrent processes (test workers) from
        # loading a library another one is still writing; make is
        # incremental, so a library older than importer.cpp is rebuilt
        with open(_SO_PATH.parent / ".build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            proc = subprocess.run(
                ["make", "-s", "-C", str(_NATIVE_DIR)],
                capture_output=True, text=True, timeout=300,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {_SO_PATH} failed:\n{proc.stdout}{proc.stderr}"
                )
            lib = ctypes.CDLL(str(_SO_PATH))
        lib.mc_generate_er_hash.restype = ctypes.c_void_p
        lib.mc_generate_er_hash.argtypes = [
            ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.mc_n.restype = ctypes.c_int64
        lib.mc_n.argtypes = [ctypes.c_void_p]
        lib.mc_nnz.restype = ctypes.c_int64
        lib.mc_nnz.argtypes = [ctypes.c_void_p]
        lib.mc_row_ptr.restype = ctypes.POINTER(ctypes.c_int64)
        lib.mc_row_ptr.argtypes = [ctypes.c_void_p]
        lib.mc_cols.restype = ctypes.POINTER(ctypes.c_int32)
        lib.mc_cols.argtypes = [ctypes.c_void_p]
        lib.mc_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def generate_er_hash(
    n: int, threshold: int, seed: int, name: str | None = None
) -> Graph:
    """Host CSR of the hash-defined G(n, p) (threaded C++ enumeration of
    the same (seed, threshold) hash the device evaluates)."""
    if not 0 <= threshold <= 0xFFFFFFFF or not 0 <= seed <= 0xFFFFFFFF:
        raise ValueError("threshold and seed are uint32")
    lib = _load()
    h = lib.mc_generate_er_hash(n, threshold, seed)
    try:
        nn = lib.mc_n(h)
        nnz = lib.mc_nnz(h)
        row_ptr = np.ctypeslib.as_array(lib.mc_row_ptr(h), shape=(nn + 1,)).copy()
        cols = np.ctypeslib.as_array(
            lib.mc_cols(h), shape=(max(nnz, 1),)
        )[:nnz].copy()
    finally:
        lib.mc_free(h)
    return Graph(n=int(nn), row_ptr=row_ptr, cols=cols, name=name or f"er_hash_{n}")
