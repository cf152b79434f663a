"""Kernel K5 — the hash graph's ELL rows, built on the device from the
graph's definition — and its plain version.

The graph is ``ops/hashgen.py``'s G(n, p), ``edge(i, j) := mix32(seed,
min(i, j), max(i, j)) < floor(p * 2**32)``; here it is laid out as the
flat ELL that ``graph/container.py:Graph.to_ell`` makes of a host CSR:
``neighbors [n_pad, d_pad]`` int32, each row's neighbours in ascending
id order, the sentinel ``n_pad`` in every padding slot and on every
phantom row (ids >= n), ``d_pad`` the max degree rounded up to
``pad_degree_to`` (``degree_pad_for``'s rule, chosen by the caller).  No
edge list and no CSR exist on either side.

The build is two passes over the same tests: ``hash_ell_degrees`` counts
each row's degree (``mc.hash_ell.count``), and ``hash_ell_fill`` writes
the rows into a rectangle as wide as those degrees need
(``mc.hash_ell.fill``); ``hash_ell`` does both, with the max degree read
to the host between them.  Each dispatches on the device:

- the CPU goes to the plain version (``hash_ell_plain`` and its two
  passes), dense torch tests over bands of rows;
- CUDA goes to ``hash_ell_cuda``, the hand-written kernel
  ``csrc/hash_ell.cu`` (built with nvcc for sm_90a at first use), one
  launch a pass; or raises.  There is no fallback from the card to the
  plain version.

The fill checks itself against the count: a row that finds another
number of neighbours, or more than ``d_pad``, raises (no row is ever cut
short).  ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from mcmc_colorer_tpu_torch.ops.hashgen import _SIGN, _i32, _mix, er_threshold
from mcmc_colorer_tpu_torch.utils.spans import span

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "hash_ell.cu"
_I32_MAX = 2**31 - 1
PLAIN_BAND_ELEMENTS = 1 << 22  # pair tests a band of the plain version holds at once

launches = 0
_built = None


def load_kernel():
    """Build (first use only) and bind the K5 library
    (``utils/cuda_build.BuiltLibrary``)."""
    global _built
    if _built is None:
        from mcmc_colorer_tpu_torch.utils.cuda_build import build_library

        built = build_library("hash_ell", SOURCE)
        fn = built.lib.hash_ell_launch
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_uint] * 2 + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        err = built.lib.hash_ell_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _built = built
    return _built


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _check_sizes(n: int, p: float, n_pad: int, d_pad: int | None = None) -> None:
    if n < 0 or not 0.0 <= p <= 1.0:
        raise ValueError(f"need n >= 0 and 0 <= p <= 1, got n={n}, p={p}")
    if not max(n, 1) <= n_pad <= _I32_MAX:
        raise ValueError(f"n_pad={n_pad} must lie in [max(n, 1), {_I32_MAX}] (n={n}): ids and "
                         f"the sentinel n_pad are int32")
    if d_pad is not None and d_pad < 1:
        raise ValueError(f"d_pad={d_pad} must be at least 1")


def _check_degrees(degrees: torch.Tensor, n: int) -> None:
    if degrees.dtype != torch.int32 or degrees.dim() != 1 or not degrees.is_contiguous():
        raise TypeError(f"degrees must be a contiguous [n_pad] int32 tensor, got "
                        f"{degrees.dtype} {tuple(degrees.shape)}")
    if degrees.shape[0] < max(n, 1):
        raise ValueError(f"degrees has {degrees.shape[0]} rows for n={n}")


def d_pad_for(max_degree: int, pad_degree_to: int, min_degree_pad: int = 1) -> int:
    """The rectangle's width: the max degree (at least ``min_degree_pad``)
    rounded up to ``pad_degree_to``, as ``Graph.to_ell`` pads it."""
    return _round_up(max(max_degree, min_degree_pad), pad_degree_to)


def hash_ell_degrees(n: int, p: float, seed: int, n_pad: int, device) -> torch.Tensor:
    """[n_pad] int32 degrees of the hash graph on ``device``, 0 on the
    phantom rows: K5's count pass on CUDA, the plain version's on the
    CPU."""
    device = torch.device(device)
    _check_sizes(n, p, n_pad)
    with span("mc.hash_ell.count"):
        if device.type == "cpu":
            return _degrees_plain(n, p, seed, n_pad, device)
        if device.type != "cuda":
            raise ValueError(f"no K5 for device {device}")
        degrees = torch.empty((n_pad,), dtype=torch.int32, device=device)
        return hash_ell_cuda(degrees, n, p, seed)


def hash_ell_fill(n: int, p: float, seed: int, degrees: torch.Tensor, d_pad: int) -> torch.Tensor:
    """The rows [n_pad, d_pad] int32 on ``degrees``' device, given the
    degrees the count pass gave (``hash_ell_degrees``; n_pad =
    ``degrees.shape[0]``).  Raises where a row's neighbours are not
    ``degrees[i]`` or do not fit ``d_pad``."""
    _check_degrees(degrees, n)
    _check_sizes(n, p, degrees.shape[0], d_pad)
    with span("mc.hash_ell.fill"):
        if degrees.device.type == "cpu":
            return _fill_plain(n, p, seed, degrees, d_pad)
        if degrees.device.type != "cuda":
            raise ValueError(f"no K5 for device {degrees.device}")
        return hash_ell_cuda(degrees, n, p, seed, d_pad)


def hash_ell(n: int, p: float, seed: int, n_pad: int, pad_degree_to: int, device):
    """(neighbors [n_pad, d_pad] int32, degrees [n_pad] int32, max
    degree) of the hash graph on ``device``: the count, the max degree to
    the host, the fill."""
    with span("mc.hash_ell"):
        degrees = hash_ell_degrees(n, p, seed, n_pad, device)
        max_degree = int(degrees.max())
        d_pad = d_pad_for(max_degree, pad_degree_to)
        return hash_ell_fill(n, p, seed, degrees, d_pad), degrees, max_degree


def hash_ell_cuda(degrees: torch.Tensor, n: int, p: float, seed: int,
                  d_pad: int | None = None):
    """Launch K5 on the current stream of ``degrees``' card.  Without
    ``d_pad``, the count pass: writes ``degrees`` ([n_pad] int32) and
    returns it.  With it, the fill pass: reads ``degrees`` and returns the
    rows [n_pad, d_pad], after reading its status back (one host sync)."""
    global launches
    _check_degrees(degrees, n)
    n_pad = degrees.shape[0]
    _check_sizes(n, p, n_pad, d_pad)
    if degrees.device.type != "cuda":
        raise ValueError(f"K5 needs CUDA tensors, got {degrees.device}")
    dev = degrees.device
    fill = d_pad is not None
    neighbors = status = None
    if fill:
        neighbors = torch.empty((n_pad, d_pad), dtype=torch.int32, device=dev)
        status = torch.zeros((1,), dtype=torch.int32, device=dev)
    lib = load_kernel().lib
    with torch.cuda.device(dev):
        rc = lib.hash_ell_launch(
            n, n_pad, d_pad or 0, seed & 0xFFFFFFFF, er_threshold(p), degrees.data_ptr(),
            None if neighbors is None else neighbors.data_ptr(),
            None if status is None else status.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"K5 launch failed: {lib.hash_ell_error_string(rc).decode()} ({rc})")
    launches += 1
    if not fill:
        return degrees
    if int(status.item()) != 0:
        raise RuntimeError(f"K5: a row's neighbours differ from its counted degree or do not "
                           f"fit d_pad={d_pad} (n={n}, n_pad={n_pad})")
    return neighbors


def hash_ell_plain(n: int, p: float, seed: int, n_pad: int, pad_degree_to: int,
                   device="cpu"):
    """Plain version of ``hash_ell``: the same (neighbors, degrees, max
    degree) from dense torch tests of every pair, a band of rows at a
    time, on ``device`` (the CPU unless asked)."""
    device = torch.device(device)
    _check_sizes(n, p, n_pad)
    degrees = _degrees_plain(n, p, seed, n_pad, device)
    max_degree = int(degrees.max())
    d_pad = d_pad_for(max_degree, pad_degree_to)
    return _fill_plain(n, p, seed, degrees, d_pad), degrees, max_degree


def hash_ell_plain_rows(n: int, p: float, seed: int, n_pad: int, d_pad: int, lo: int, hi: int,
                        device="cpu"):
    """Rows [lo, hi) of the plain version's [n_pad, d_pad] rectangle and
    their degrees, both passes run over those rows alone (phantom rows at
    the sentinel, degree 0): what a check of sampled rows of a full-size
    build compares against."""
    device = torch.device(device)
    _check_sizes(n, p, n_pad, d_pad)
    if not 0 <= lo <= hi <= n_pad:
        raise ValueError(f"rows [{lo}, {hi}) must lie in [0, n_pad={n_pad}]")
    degrees = torch.zeros((hi - lo,), dtype=torch.int32, device=device)
    out = torch.full((hi - lo, d_pad), n_pad, dtype=torch.int32, device=device)
    real = max(0, min(hi, n) - lo)
    if real:
        degrees[:real] = _count_rows(n, p, seed, lo, lo + real, device)
        _fill_rows(n, p, seed, degrees[:real], out[:real], lo)
    return out, degrees


def _band_edges(n: int, p: float, seed: int, r0: int, r1: int, device) -> torch.Tensor:
    """[r1 - r0, n] bool: edge(i, j) for rows i in [r0, r1)."""
    rows = torch.arange(r0, r1, dtype=torch.int32, device=device)[:, None]
    cols = torch.arange(n, dtype=torch.int32, device=device)[None, :]
    h = _mix(seed & 0xFFFFFFFF, torch.minimum(rows, cols), torch.maximum(rows, cols))
    # uint32 h < t as int32 bit patterns (ops/hashgen.py's module docstring)
    return ((h ^ _i32(_SIGN)) < _i32(er_threshold(p) ^ _SIGN)) & (rows != cols)


def _bands(n: int, lo: int, hi: int):
    band = max(1, PLAIN_BAND_ELEMENTS // max(n, 1))
    for r0 in range(lo, hi, band):
        yield r0, min(hi, r0 + band)


def _count_rows(n: int, p: float, seed: int, lo: int, hi: int, device) -> torch.Tensor:
    """[hi - lo] int32 degrees of the real rows [lo, hi)."""
    degrees = torch.empty((hi - lo,), dtype=torch.int32, device=device)
    for r0, r1 in _bands(n, lo, hi):
        degrees[r0 - lo:r1 - lo] = _band_edges(n, p, seed, r0, r1, device).sum(
            1, dtype=torch.int32)
    return degrees


def _fill_rows(n: int, p: float, seed: int, degrees: torch.Tensor, out: torch.Tensor,
               lo: int) -> None:
    """Write the real rows [lo, lo + len(out)) into ``out`` (the sentinel
    already in every slot), given their counted ``degrees``; raises where
    a row finds another number of neighbours or more than ``out`` holds."""
    d_pad = out.shape[1]
    for r0, r1 in _bands(n, lo, lo + out.shape[0]):
        e = _band_edges(n, p, seed, r0, r1, out.device)
        found = e.sum(1, dtype=torch.int32)
        if not torch.equal(found, degrees[r0 - lo:r1 - lo]) or int(found.max()) > d_pad:
            raise RuntimeError(f"a row's neighbours differ from its counted degree or do not "
                               f"fit d_pad={d_pad} (n={n})")
        r, c = e.nonzero(as_tuple=True)  # row-major: each row's ids ascending
        slot = (torch.cumsum(e, 1, dtype=torch.int32) - 1)[r, c]
        out[r + (r0 - lo), slot.long()] = c.to(torch.int32)


def _degrees_plain(n: int, p: float, seed: int, n_pad: int, device) -> torch.Tensor:
    degrees = torch.zeros((n_pad,), dtype=torch.int32, device=device)
    degrees[:n] = _count_rows(n, p, seed, 0, n, device)
    return degrees


def _fill_plain(n: int, p: float, seed: int, degrees: torch.Tensor, d_pad: int) -> torch.Tensor:
    n_pad = degrees.shape[0]
    out = torch.full((n_pad, d_pad), n_pad, dtype=torch.int32, device=degrees.device)
    _fill_rows(n, p, seed, degrees[:n], out[:n], 0)
    return out
