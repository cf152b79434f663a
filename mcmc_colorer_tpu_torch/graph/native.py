"""ctypes bindings of the C++ graph library (``native/importer.cpp``).

Counterpart of ``graph/native.py``: the edge-list importer
(``load_edge_list``, ``mc_import``), the ER and Barabási–Albert samplers
(``generate_er``, ``generate_ba``), the dataset writer
(``generate_dataset``), the hash-graph enumerator (``generate_er_hash``)
and the compiled sequential chain (``run_mcmc_seq``).  The library ``native/build/libmcgraph.so`` is
git-ignored, so it is built with ``make -C native`` at first use; a
failed build raises (the port has no silent Python fallback; the pure
Python importer ``graph/io.py:load_edge_list_py`` is the test oracle).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from mcmc_colorer_tpu_torch.graph.container import Graph

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_SO_PATH = _NATIVE_DIR / "build" / "libmcgraph.so"

_lock = threading.Lock()
_lib = None

_SIGNATURES = {
    "mc_import": (ctypes.c_void_p, [ctypes.c_char_p]),
    "mc_generate_er": (ctypes.c_void_p, [ctypes.c_int64, ctypes.c_double, ctypes.c_uint64]),
    "mc_generate_ba": (ctypes.c_void_p, [ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64]),
    "mc_generate_er_hash": (ctypes.c_void_p, [ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32]),
    "mc_generate_dataset": (
        ctypes.c_int64,
        [ctypes.c_char_p, ctypes.c_int64, ctypes.c_double, ctypes.c_uint64, ctypes.c_int],
    ),
    "mc_n": (ctypes.c_int64, [ctypes.c_void_p]),
    "mc_nnz": (ctypes.c_int64, [ctypes.c_void_p]),
    "mc_row_ptr": (ctypes.POINTER(ctypes.c_int64), [ctypes.c_void_p]),
    "mc_cols": (ctypes.POINTER(ctypes.c_int32), [ctypes.c_void_p]),
    "mc_name": (ctypes.c_char_p, [ctypes.c_void_p, ctypes.c_int64]),
    "mc_error": (ctypes.c_char_p, [ctypes.c_void_p]),
    "mc_free": (None, [ctypes.c_void_p]),
    "mc_from_csr": (
        ctypes.c_void_p,
        [ctypes.c_int64, np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
         np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")],
    ),
    "mc_mcmc_seq": (
        ctypes.c_int64,
        [ctypes.c_void_p, ctypes.c_int32, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
         ctypes.c_int64, ctypes.c_uint64, np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")],
    ),
}


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
        for fn_name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, fn_name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return lib


def available() -> bool:
    """True when the library builds and loads, False when its build
    raises.  For tests that skip without it; no entry point picks another
    path by it."""
    try:
        _load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def _take_graph(lib, h, name: str, with_names: bool = False,
                error=ValueError) -> Graph:
    """Copy a native handle's CSR (and names) into a ``Graph``; frees it."""
    try:
        nn = lib.mc_n(h)
        if nn < 0:
            raise error(lib.mc_error(h).decode())
        nnz = lib.mc_nnz(h)
        row_ptr = np.ctypeslib.as_array(lib.mc_row_ptr(h), shape=(nn + 1,)).copy()
        cols = np.ctypeslib.as_array(lib.mc_cols(h), shape=(max(nnz, 1),))[:nnz].copy()
        names = [lib.mc_name(h, i).decode() for i in range(nn)] if with_names else None
    finally:
        lib.mc_free(h)
    return Graph(n=int(nn), row_ptr=row_ptr, cols=cols, node_names=names, name=name)


def load_edge_list(path: str, name: str | None = None, with_names: bool = True) -> Graph:
    """Two-pass C++ import of an edge-list file (one header line, then
    ``src dst [weight]``; string ids mapped to dense ints in first-seen
    order, reverse edges added, self-loops dropped)."""
    lib = _load()
    h = lib.mc_import(os.fsencode(path))
    name = name or os.path.basename(path).rsplit(".", 1)[0]
    return _take_graph(
        lib, h, name, with_names,
        error=lambda msg: OSError(f"{path}: {msg}"),
    )


def generate_er(n: int, p: float, seed: int = 0, name: str | None = None) -> Graph:
    """In-memory ER(n, p) -> CSR in one C++ pass (geometric skips)."""
    lib = _load()
    return _take_graph(lib, lib.mc_generate_er(n, p, seed), name or f"er_{n}_{p}")


def generate_ba(n: int, m_per_node: int, seed: int = 0, name: str | None = None) -> Graph:
    """In-memory Barabási–Albert(n, m) -> CSR in one C++ pass."""
    lib = _load()
    return _take_graph(
        lib, lib.mc_generate_ba(n, m_per_node, seed), name or f"ba_{n}_{m_per_node}"
    )


def generate_er_hash(n: int, threshold: int, seed: int, name: str | None = None) -> Graph:
    """Host CSR of the hash-defined G(n, p) (threaded C++ enumeration of
    the same (seed, threshold) hash the device evaluates)."""
    if not 0 <= threshold <= 0xFFFFFFFF or not 0 <= seed <= 0xFFFFFFFF:
        raise ValueError("threshold and seed are uint32")
    lib = _load()
    return _take_graph(
        lib, lib.mc_generate_er_hash(n, threshold, seed), name or f"er_hash_{n}"
    )


def generate_dataset(path: str, n: int, p: float, seed: int = 10000,
                     named: bool = True) -> int:
    """C++ datasetGen: writes ER(n, p) in the native edge-list format and
    returns the number of undirected edges written."""
    lib = _load()
    m = lib.mc_generate_dataset(os.fsencode(path), n, p, seed, int(named))
    if m < 0:
        raise OSError(f"cannot write {path}")
    return int(m)


def run_mcmc_seq(
    graph: Graph,
    n_colors: int,
    epsilon: float = 1e-8,
    taboo_iterations: int = 0,
    max_iterations: int = 250,
    z: int = 0,
    seed: int = 0,
) -> tuple[np.ndarray, int]:
    """The compiled sequential MCMC chain (``native/importer.cpp:mc_mcmc_seq``
    over ``mc_from_csr``): the C++ baseline at the reference CPU's speed.
    Returns (colours int32 [n], iterations)."""
    rp = np.ascontiguousarray(graph.row_ptr, dtype=np.int64)
    cols = np.ascontiguousarray(graph.cols, dtype=np.int32)
    if rp.shape != (graph.n + 1,) or cols.shape[0] < rp[-1]:
        raise ValueError(f"not a CSR of {graph.n} vertices: row_ptr {rp.shape}, cols "
                         f"{cols.shape}")
    lib = _load()
    h = lib.mc_from_csr(graph.n, rp, cols)
    try:
        out = np.empty(graph.n, dtype=np.int32)
        iters = lib.mc_mcmc_seq(h, n_colors, float(epsilon), taboo_iterations, max_iterations,
                                z, seed, out)
    finally:
        lib.mc_free(h)
    return out, int(iters)
