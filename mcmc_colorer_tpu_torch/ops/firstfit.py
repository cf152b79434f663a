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

The tailcut's round (``models/mcmc.py:_tailcut_body``) takes a second
instance of the kernel, chosen by the call: given ``flag`` (with ``out``,
``count`` and the rows' first id ``row0``), ``first_fit`` also writes
whether some neighbour holds the row's own colour and adds each chain's
count of such neighbours with a higher id, from the colours it looks up
for the first fit, so a round reads its ids once.  ``allow`` is then
None: the tailcut allows every colour.  ``lower_movable`` is the round's
second pass: whether a movable row has a movable neighbour of a lower
id, the kernel reading only the movable rows' ids.

Both are integer work and agree exactly.  ``launches`` counts K3's
launches, ``lower_launches`` the lower-movable kernel's.
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
lower_launches = 0
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
        fn = built.lib.first_fit_tailcut_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        fn = built.lib.lower_movable_launch
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = built.lib.first_fit_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _built = built
    return _built


def _check(nc, allow, n_colors, cur):
    if nc.dtype != torch.int32 or nc.dim() != 2:
        raise TypeError(f"nc must be 2-D int32, got {nc.dtype} {tuple(nc.shape)}")
    if allow is not None and (allow.dim() != 1 or allow.shape[0] != n_colors):
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


def _check_call(neighbors, colors, allow, n_colors, cur, row0, out, flag, count):
    """``_check_ids``; then, given ``flag``, the tailcut call's outputs:
    ``out`` int32 and ``flag`` bool shaped as ``colors``, ``count`` int64
    [C] ([] for one colour vector), rows row0 .. row0 + rows - 1 inside the
    vector, no ``cur`` and no ``allow``: the tailcut allows and bars no
    colour.  ``allow`` is None there and only there."""
    _check_ids(neighbors, colors, allow, n_colors, cur)
    if flag is None:
        if allow is None:
            raise ValueError("allow may be None only in the tailcut call")
        return
    if out is None or count is None:
        raise ValueError("the tailcut call takes out, flag and count together")
    if cur is not None or allow is not None:
        raise ValueError("the tailcut call allows every colour: allow and cur must be None")
    want = [(out, torch.int32, colors.shape), (flag, torch.bool, colors.shape),
            (count, torch.int64, colors.shape[:-1])]
    for t, dtype, shape in want:
        if t.dtype != dtype or t.shape != shape:
            raise TypeError(f"the tailcut call wants {dtype} {tuple(shape)}, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != neighbors.device:
            raise ValueError(f"neighbors on {neighbors.device} but an output on {t.device}")
    if not 0 <= row0 <= colors.shape[-1] - neighbors.shape[0]:
        raise ValueError(f"rows {row0} .. {row0 + neighbors.shape[0]} outside the "
                         f"{colors.shape[-1]} ids")


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


def first_fit(neighbors, colors, allow, n_colors: int, cur=None, *, row0: int = 0,
              out=None, flag=None, count=None) -> torch.Tensor:
    """[rows] int32 ([C, rows] for colours [C, n]): the smallest allowed
    colour other than ``cur`` that no neighbour holds, or -1.  Given
    ``flag``, the tailcut's call (the module's docstring): the rows are ids
    ``row0`` onwards, written into ``out`` and ``flag`` (shaped as
    ``colors``) with ``count`` added to, and ``out`` is returned."""
    # the greedy call passes no tailcut keyword on, so its launches look
    # as they did before the tailcut call existed
    tailcut = {} if flag is None else dict(row0=row0, out=out, flag=flag, count=count)
    if neighbors.device.type == "cpu":
        return first_fit_plain(neighbors, colors, allow, n_colors, cur, **tailcut)
    if neighbors.device.type != "cuda":
        raise ValueError(f"no K3 for device {neighbors.device}")
    return first_fit_cuda(neighbors, colors, allow, n_colors, cur, **tailcut)


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


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.first_fit_error_string(rc).decode()} "
                           f"({rc})")


def first_fit_cuda(neighbors, colors, allow, n_colors: int, cur=None, *, row0: int = 0,
                   out=None, flag=None, count=None) -> torch.Tensor:
    """Launch K3 on the current stream of the tensors' card: the greedy
    instance, or given ``flag`` the tailcut's (``first_fit``)."""
    global launches
    tailcut = flag is not None
    _check_call(neighbors, colors, allow, n_colors, cur, row0, out, flag, count)
    if neighbors.device.type != "cuda":
        raise ValueError(f"K3 needs CUDA tensors, got {neighbors.device}")
    if not all(t is None or t.is_contiguous() for t in (neighbors, colors, cur, out, flag)):
        raise ValueError("K3 needs contiguous neighbors, colors, cur, out and flag")
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
    if not tailcut:
        allow_bits = pack_bits(allow)
        out = torch.empty((*colors.shape[:-1], rows), dtype=torch.int32,
                          device=neighbors.device)
    if rows == 0 or chains == 0:
        return out
    lib = load_kernel().lib
    with torch.cuda.device(neighbors.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tailcut:
            rc = lib.first_fit_tailcut_launch(
                neighbors.data_ptr(), colors.data_ptr(), colors.shape[-1], out.data_ptr(),
                flag.data_ptr(), count.data_ptr(), rows, d_pad, n_colors, rows_per_block,
                copies, chains, row0, stream,
            )
        else:
            rc = lib.first_fit_launch(
                neighbors.data_ptr(), colors.data_ptr(), colors.shape[-1],
                allow_bits.data_ptr(), cur.data_ptr() if cur is not None else None,
                out.data_ptr(), rows, d_pad, n_colors, rows_per_block, copies, chains, stream,
            )
    _raise_on(rc, lib, "K3")
    launches += 1
    return out


def first_fit_plain(neighbors, colors, allow, n_colors: int, cur=None, *, row0: int = 0,
                    out=None, flag=None, count=None) -> torch.Tensor:
    """Plain version of K3: the gather ``neighbor_colors`` (padding ids
    land on -1), then ``first_fit_reference`` on the gathered band; with a
    chain axis, on the chains' bands stacked row-wise.  Given ``flag``,
    the tailcut's call: the same gather also gives the flag and count."""
    _check_call(neighbors, colors, allow, n_colors, cur, row0, out, flag, count)
    if allow is None:
        allow = torch.ones((n_colors,), dtype=torch.int32, device=neighbors.device)
    if flag is not None:
        cols = colors if colors.dim() == 2 else colors[None]
        chains, rows = cols.shape[0], neighbors.shape[0]
        nc = neighbor_colors_chains(neighbors, cols)
        e = row0 + rows
        same = nc == cols[:, row0:e, None]
        ids = torch.arange(row0, e, dtype=torch.int32, device=neighbors.device)
        count += (same & (neighbors > ids[:, None])[None]).sum((1, 2)).reshape(count.shape)
        flag[..., row0:e] = same.any(2).reshape(flag[..., row0:e].shape)
        fit = first_fit_reference(nc.reshape(chains * rows, -1), allow, n_colors)
        out[..., row0:e] = fit.reshape(out[..., row0:e].shape)
        return out
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


def _check_lower(neighbors, movable, row0, out):
    if neighbors.dtype != torch.int32 or neighbors.dim() != 2:
        raise TypeError(f"neighbors must be 2-D int32, got {neighbors.dtype} "
                        f"{tuple(neighbors.shape)}")
    if movable.dtype != torch.bool or movable.dim() != 2:
        raise TypeError(f"movable must be [C, n] bool, got {movable.dtype} "
                        f"{tuple(movable.shape)}")
    if out.dtype != torch.bool or out.shape != movable.shape:
        raise TypeError(f"out must be bool {tuple(movable.shape)}, got {out.dtype} "
                        f"{tuple(out.shape)}")
    for t in (movable, out):
        if t.device != neighbors.device:
            raise ValueError(f"neighbors on {neighbors.device} but an argument on {t.device}")
    if not 0 <= row0 <= movable.shape[1] - neighbors.shape[0]:
        raise ValueError(f"rows {row0} .. {row0 + neighbors.shape[0]} outside the "
                         f"{movable.shape[1]} ids")


def lower_movable(neighbors, movable, *, row0: int = 0, out) -> torch.Tensor:
    """The tailcut round's second pass over the rows of ``neighbors``,
    which are ids ``row0`` onwards: ``out[c, v]`` = ``movable[c, v]`` and
    some neighbour ``u < v`` has ``movable[c, u]`` (``movable``, ``out``
    [C, n] bool; the padding id counts nowhere).  CPU tensors go to
    ``lower_movable_plain``, CUDA tensors to the kernel; returns ``out``."""
    if neighbors.device.type == "cpu":
        return lower_movable_plain(neighbors, movable, row0=row0, out=out)
    if neighbors.device.type != "cuda":
        raise ValueError(f"no lower-movable kernel for device {neighbors.device}")
    return lower_movable_cuda(neighbors, movable, row0=row0, out=out)


def lower_movable_cuda(neighbors, movable, *, row0: int = 0, out) -> torch.Tensor:
    """Launch the lower-movable kernel on the current stream of the
    tensors' card."""
    global lower_launches
    _check_lower(neighbors, movable, row0, out)
    if neighbors.device.type != "cuda":
        raise ValueError(f"the lower-movable kernel needs CUDA tensors, got {neighbors.device}")
    if not all(t.is_contiguous() for t in (neighbors, movable, out)):
        raise ValueError("the lower-movable kernel needs contiguous neighbors, movable and out")
    rows, d_pad = neighbors.shape
    chains, n_ids = movable.shape
    if rows == 0 or chains == 0:
        return out
    lib = load_kernel().lib
    with torch.cuda.device(neighbors.device):
        rc = lib.lower_movable_launch(
            neighbors.data_ptr(), movable.data_ptr(), n_ids, out.data_ptr(), rows, d_pad,
            row0, chains, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, lib, "lower-movable")
    lower_launches += 1
    return out


def lower_movable_plain(neighbors, movable, *, row0: int = 0, out) -> torch.Tensor:
    """Plain version of ``lower_movable``: every row's neighbours' flags
    gathered (the padding id on a False slot), then the test."""
    _check_lower(neighbors, movable, row0, out)
    chains, rows = movable.shape[0], neighbors.shape[0]
    e = row0 + rows
    ext = torch.cat([movable, movable.new_zeros((chains, 1))], 1)
    nb = ext.index_select(1, neighbors.reshape(-1)).reshape(chains, *neighbors.shape)
    ids = torch.arange(row0, e, dtype=torch.int32, device=neighbors.device)
    out[:, row0:e] = (nb & (neighbors < ids[:, None])[None]).any(2) & movable[:, row0:e]
    return out
