"""Kernel K6 — the hash graph's bit-packed adjacency and its degrees,
built on the card in one launch — bound to torch.

The words are ``ops/hashgen.py``'s: word w of row i, bit b holds column
``(w // 128) * 4096 + b * 128 + w % 128`` of ``edge(i, j) := mix32(seed,
min(i, j), max(i, j)) < floor(p * 2**32)``, 0 on the diagonal, on the
columns from n on and on the phantom rows.  ``ops/hashgen.py:
_gen_packed_rows`` sends a CUDA tensor here and a CPU tensor to its plain
version (``gen_packed_rows_plain``); there is no fallback from the card
to the plain version.  The kernel is ``csrc/hash_packed.cu``, built with
nvcc for sm_90a at first use.  ``launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from mcmc_colorer_tpu_torch.ops.dense_adj import packed_adj_words

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "hash_packed.cu"
WINDOW_WORDS = 128  # words a row a 4096-column window
_I32_MAX = 2**31 - 1

launches = 0
_built = None


def load_kernel():
    """Build (first use only) and bind the K6 library
    (``utils/cuda_build.BuiltLibrary``)."""
    global _built
    if _built is None:
        from mcmc_colorer_tpu_torch.utils.cuda_build import build_library

        built = build_library("hash_packed", SOURCE)
        fn = built.lib.hash_packed_launch
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_uint] * 2 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        err = built.lib.hash_packed_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _built = built
    return _built


def hash_packed_cuda(r0: int, n: int, t: int, seed32: int, out: torch.Tensor | None = None,
                     degrees: torch.Tensor | None = None) -> None:
    """Launch K6 on the current stream of the outputs' card: rows [r0, r0 +
    rows) of the packed adjacency of the hash graph on n vertices
    (threshold ``t``, seed ``seed32``, both uint32) into ``out`` ([rows,
    words] int32, row k holding vertex r0 + k) and their degrees into
    ``degrees`` ([rows] int32).  Either output may be None, not both.
    Every check raises before the launch, the sizes before the device."""
    global launches
    if out is None and degrees is None:
        raise ValueError("K6 has nothing to write: give out, degrees or both")
    for name, x, dim in (("out", out, 2), ("degrees", degrees, 1)):
        if x is not None and (x.dtype != torch.int32 or x.dim() != dim or not x.is_contiguous()):
            raise TypeError(f"{name} must be a contiguous {dim}-D int32 tensor, got "
                            f"{x.dtype} {tuple(x.shape)}")
    rows = (out if out is not None else degrees).shape[0]
    words = out.shape[1] if out is not None else packed_adj_words(max(n, 1))
    if degrees is not None and degrees.shape[0] != rows:
        raise ValueError(f"degrees has {degrees.shape[0]} rows for {rows} rows of words")
    if n < 0 or r0 < 0 or r0 + rows > _I32_MAX:
        raise ValueError(f"need n >= 0 and rows [r0, r0 + rows) = [{r0}, {r0 + rows}) within "
                         f"[0, {_I32_MAX}]: ids are int32")
    if words < WINDOW_WORDS or words % WINDOW_WORDS or words * 32 < n:
        raise ValueError(f"words={words} must be a positive multiple of {WINDOW_WORDS} whose "
                         f"columns hold every one of n={n} vertices")
    if not (0 <= t <= 0xFFFFFFFF and 0 <= seed32 <= 0xFFFFFFFF):
        raise ValueError(f"threshold {t} and seed {seed32} must be uint32")
    devices = {x.device for x in (out, degrees) if x is not None}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"K6 needs its outputs on one CUDA device, got {sorted(map(str, devices))}")
    if rows == 0:
        return
    dev = next(iter(devices))
    lib = load_kernel().lib
    with torch.cuda.device(dev):
        rc = lib.hash_packed_launch(
            r0, rows, n, words, seed32, t,
            None if out is None else out.data_ptr(),
            None if degrees is None else degrees.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"K6 launch failed: {lib.hash_packed_error_string(rc).decode()} ({rc})")
    launches += 1
