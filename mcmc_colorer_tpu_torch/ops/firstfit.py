"""Kernel K3 — masked first fit over gathered neighbour colours — and its
plain version.

Replaces ``mcmc_colorer_tpu/ops/pallas_firstfit.py:pallas_first_fit``
together with the neighbour gather in front of it.  Per row of neighbour
ids ``neighbors`` it returns the smallest colour ``c < n_colors`` that no
neighbour's colour ``ext[id]`` is (``ext`` = ``colors`` with a -1 slot
for the ELL padding id), that ``allow[c]`` admits and that is not the
row's own colour ``cur`` (when given), or -1.

``first_fit`` dispatches on where ``neighbors`` lies:

- CPU tensors go to ``first_fit_plain``: ``neighbor_colors`` and then
  ``first_fit_reference``, the first fit over a gathered band
  (``occupancy_matrix``, the eligibility mask, ``argmax`` with -1 where
  nothing is eligible);
- CUDA tensors go to the hand-written kernel ``csrc/first_fit.cu``
  (built with nvcc for sm_90a at first use), which gathers the colours
  itself, or raise.  There is no fallback from the card to the plain
  version.

Both take one colour vector ``[n]`` or a chain axis ``[C, n]`` (with
``cur`` then ``[C, rows]``; ``neighbors`` and ``allow`` are shared): an
ensemble's tailcut, where JAX vmaps its first fit over the chains.  The
result is then ``[C, rows]``, one launch for all chains.

Both are integer work and agree exactly.  ``launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from mcmc_colorer_tpu_torch.ops.neighbor import (
    neighbor_colors,
    neighbor_colors_chains,
    occupancy_matrix,
)
from mcmc_colorer_tpu_torch.ops.packed_nc import SMEM_BLOCK_BYTES

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "first_fit.cu"
ROWS_PER_BLOCK = 8  # one warp per row
COPIES = 4          # interleaved copies of a row's occupancy mask
# one row's occupancy bitmask (n_colors bits) must fit a block's shared
# memory: 232,448 bytes = 1,859,584 colours, a multiple of 128
PALETTE_MAX = SMEM_BLOCK_BYTES * 8

launches = 0
_built = None


def palette_ok(n_colors: int) -> bool:
    """Whether K2 and K3 serve this palette on the card (the counterpart
    of ``pallas_palette_ok``, re-derived from shared memory)."""
    return 0 < (n_colors + 127) // 128 * 128 <= PALETTE_MAX


def load_kernel():
    """Build (first use only) and bind the K3 library
    (``utils/cuda_build.BuiltLibrary``)."""
    global _built
    if _built is None:
        from mcmc_colorer_tpu_torch.utils.cuda_build import build_library

        built = build_library("first_fit", SOURCE)
        fn = built.lib.first_fit_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        err = built.lib.first_fit_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _built = built
    return _built


def _check(nc, allow, n_colors, cur):
    if nc.dtype != torch.int32 or nc.dim() != 2:
        raise TypeError(f"nc must be 2-D int32, got {nc.dtype} {tuple(nc.shape)}")
    if allow.dim() != 1 or allow.shape[0] != n_colors:
        raise ValueError(f"allow must be [{n_colors}], got {tuple(allow.shape)}")
    if n_colors <= 0:
        raise ValueError(f"n_colors={n_colors} must be positive")
    if cur is not None and (cur.dtype != torch.int32 or cur.shape != nc.shape[:1]):
        raise TypeError(f"cur must be [{nc.shape[0]}] int32, got {cur.dtype} {tuple(cur.shape)}")
    for t in (allow, cur):
        if t is not None and t.device != nc.device:
            raise ValueError(f"nc on {nc.device} but an argument on {t.device}")


def _check_ids(neighbors, colors, allow, n_colors, cur):
    """``_check`` on the ids, plus the colour vector they index: [n], or
    [C, n] with ``cur`` [C, rows]."""
    if colors.dtype != torch.int32 or colors.dim() not in (1, 2):
        raise TypeError(f"colors must be [n] or [C, n] int32, got {colors.dtype} "
                        f"{tuple(colors.shape)}")
    if colors.device != neighbors.device:
        raise ValueError(f"neighbors on {neighbors.device} but colors on {colors.device}")
    if colors.dim() == 2 and cur is not None:
        want = (colors.shape[0], neighbors.shape[0])
        if cur.dtype != torch.int32 or tuple(cur.shape) != want:
            raise TypeError(f"cur must be {list(want)} int32, got {cur.dtype} "
                            f"{tuple(cur.shape)}")
        cur = cur[0]
    _check(neighbors, allow, n_colors, cur)


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """[n] bool/int -> [ceil(n/32)] int32 holding uint32 bit patterns: bit
    c % 32 of word c // 32 is set iff mask[c] != 0."""
    n = mask.shape[0]
    words = (n + 31) // 32
    m = torch.zeros((words * 32,), dtype=torch.int64, device=mask.device)
    m[:n] = (mask != 0).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    v = (m.reshape(words, 32) << shifts).sum(1)  # < 2**32
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def first_fit(neighbors, colors, allow, n_colors: int, cur=None) -> torch.Tensor:
    """[rows] int32 ([C, rows] for colours [C, n]): the smallest allowed
    colour other than ``cur`` that no neighbour holds, or -1."""
    if neighbors.device.type == "cpu":
        return first_fit_plain(neighbors, colors, allow, n_colors, cur)
    if neighbors.device.type != "cuda":
        raise ValueError(f"no K3 for device {neighbors.device}")
    return first_fit_cuda(neighbors, colors, allow, n_colors, cur)


def _kernel_shape(n_colors: int):
    """(rows a block, mask copies): ROWS_PER_BLOCK rows of COPIES copies
    each if they fit shared memory; wide palettes take fewer copies, then
    fewer rows."""
    n_words = (n_colors + 31) // 32
    rows = max(1, min(ROWS_PER_BLOCK, SMEM_BLOCK_BYTES // (n_words * 4)))
    copies = COPIES
    while copies > 1 and rows * n_words * copies * 4 > SMEM_BLOCK_BYTES:
        copies //= 2
    return rows, copies


def first_fit_cuda(neighbors, colors, allow, n_colors: int, cur=None) -> torch.Tensor:
    """Launch K3 on the current stream of the tensors' card."""
    global launches
    _check_ids(neighbors, colors, allow, n_colors, cur)
    if neighbors.device.type != "cuda":
        raise ValueError(f"K3 needs CUDA tensors, got {neighbors.device}")
    if not (neighbors.is_contiguous() and colors.is_contiguous()
            and (cur is None or cur.is_contiguous())):
        raise ValueError("K3 needs contiguous neighbors, colors and cur")
    if not palette_ok(n_colors):
        raise ValueError(
            f"n_colors={n_colors}: one row's occupancy bitmask exceeds the "
            f"{SMEM_BLOCK_BYTES} bytes of shared memory a block may use"
        )
    rows, d_pad = neighbors.shape
    if d_pad % 4 == 0 and neighbors.data_ptr() % 16:
        raise ValueError("K3 reads rows of d_pad % 4 == 0 as 16-byte vectors: align neighbors")
    rows_per_block, copies = _kernel_shape(n_colors)
    chains = colors.shape[0] if colors.dim() == 2 else 1
    allow_bits = pack_bits(allow)
    out = torch.empty((*colors.shape[:-1], rows), dtype=torch.int32, device=neighbors.device)
    if rows == 0 or chains == 0:
        return out
    lib = load_kernel().lib
    with torch.cuda.device(neighbors.device):
        rc = lib.first_fit_launch(
            neighbors.data_ptr(), colors.data_ptr(), colors.shape[-1],
            allow_bits.data_ptr(), cur.data_ptr() if cur is not None else None,
            out.data_ptr(), rows, d_pad, n_colors, rows_per_block, copies, chains,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"K3 launch failed: {lib.first_fit_error_string(rc).decode()} ({rc})"
        )
    launches += 1
    return out


def first_fit_plain(neighbors, colors, allow, n_colors: int, cur=None) -> torch.Tensor:
    """Plain version of K3: the gather ``neighbor_colors`` (padding ids
    land on -1), then ``first_fit_reference`` on the gathered band; with a
    chain axis, on the chains' bands stacked row-wise."""
    _check_ids(neighbors, colors, allow, n_colors, cur)
    if colors.dim() == 1:
        return first_fit_reference(neighbor_colors(neighbors, colors), allow, n_colors, cur)
    chains, rows = colors.shape[0], neighbors.shape[0]
    nc = neighbor_colors_chains(neighbors, colors).reshape(chains * rows, -1)
    flat_cur = cur.reshape(-1) if cur is not None else None
    return first_fit_reference(nc, allow, n_colors, flat_cur).reshape(chains, rows)


def first_fit_reference(nc, allow, n_colors: int, cur=None) -> torch.Tensor:
    """First fit over a gathered band ``nc`` of neighbour colours (the XLA
    formulation of ``tests/test_pallas_firstfit.py``): occupancy,
    eligibility, argmax."""
    _check(nc, allow, n_colors, cur)
    occ = occupancy_matrix(nc, n_colors)
    col_ids = torch.arange(n_colors, dtype=torch.int32, device=nc.device)[None, :]
    eligible = ~occ & (allow != 0)[None, :]
    if cur is not None:
        eligible &= col_ids != cur[:, None]
    # argmax returns the first index among ties, as jnp.argmax does
    first = torch.argmax(eligible.to(torch.int32), dim=1).to(torch.int32)
    return torch.where(eligible.any(1), first, -1)
