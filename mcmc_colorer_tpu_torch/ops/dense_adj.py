"""Bit-packed adjacency and the neighbour-colour counts NC = A·onehot(colors).

Counterpart of the packed part of ``mcmc_colorer_tpu/ops/dense_adj.py``.
A is stored as ``torch.int32`` words holding the uint32 bit patterns of
the JAX package's ``[n_pad, words]`` uint32 array, in the same
``packed_bit_coords`` order: within each ``PACKED_K_CHUNK``-wide column
window, column ``jl`` lives in word ``jl % 128`` at bit ``jl // 128``.
``(x >> b) & 1`` reads bit ``b`` correctly under torch's arithmetic shift.

A host graph's packed A is built on the device from its ELL
(``get_adjacency``, cached on the graph); a frontier's rows are unpacked
from A to ascending id lists (``packed_rows_to_ids``).  The dense int8
kind of the JAX package is not ported (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import numpy as np
import torch

PACKED_K_CHUNK = 4096  # one window: 128 words x 32 bits

# Device-memory bound of the resident path on one 80 GB H100.  Live at
# once during a run, for n_pad vertices and a palette padded to c colours:
#   A                 n_pad * packed_adj_words(n_pad) * 4   (~ n_pad^2 / 8)
#   NC, twice         2 * n_pad * c * 4   (the tailcut holds entry and exit NC)
#   sweep temporaries 8 * SWEEP_BLOCK_BYTES   (~8 [block, c] float32 buffers)
# PACKED_ADJ_MAX_N is the largest multiple of 2048 whose total stays
# within RESIDENT_BUDGET_BYTES at c = 2048 (palettes up to 2048 colours);
# wider palettes are checked exactly by ``resident_bytes`` once known.
HBM_BYTES = 80 * 10**9
RESIDENT_BUDGET_BYTES = int(0.9 * HBM_BYTES)  # headroom: context, allocator
SWEEP_BLOCK_BYTES = 256 * 1024**2
PACKED_ADJ_MAX_N = 684_032


def packed_adj_words(n_pad: int) -> int:
    """Words per row: whole 4096-column windows of 128 words each."""
    return (n_pad + PACKED_K_CHUNK - 1) // PACKED_K_CHUNK * 128


def packed_adj_bytes(n_pad: int) -> int:
    return n_pad * packed_adj_words(n_pad) * 4


# A sharded colorer's strip (``parallel/sharded.py``: a rank's rows of A,
# [n_loc, packed_adj_words(n_pad)]) is held to the bytes of the largest A
# the resident budget admits above, ~58.5 GB: the rest of that budget
# then still holds the strip's NC and sweep temporaries
STRIP_MAX_BYTES = packed_adj_bytes(PACKED_ADJ_MAX_N)


def n_col_pad_of(n_colors: int) -> int:
    """Colour axis padded to a multiple of 128 (padded columns stay 0)."""
    return (n_colors + 127) // 128 * 128


def resident_bytes(n_pad: int, n_col_pad: int) -> int:
    """Device bytes a resident run holds at once (formula above)."""
    return (
        packed_adj_bytes(n_pad)
        + 2 * n_pad * n_col_pad * 4
        + 8 * SWEEP_BLOCK_BYTES
    )


def packed_bit_coords(v: np.ndarray):
    """Column index -> (word, bit) in the packed_bit_coords order."""
    window, jl = v // PACKED_K_CHUNK, v % PACKED_K_CHUNK
    word = window * 128 + jl % 128
    bit = jl // 128
    return word, bit


def neighbor_color_counts(
    adj: torch.Tensor,          # [n_pad, words] int32 (uint32 bit patterns)
    colors: torch.Tensor,       # [n_pad] int32 (out-of-palette = phantom)
    n_colors: int,
    node_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """[n_pad, n_col_pad] int32 neighbour colour counts.  Vertices outside
    ``node_mask`` are recoloured -1 and count nowhere; the colour axis is
    padded to a multiple of 128.  Runs kernel K1 on CUDA tensors and its
    plain version on CPU tensors (``ops/packed_nc.py``)."""
    from mcmc_colorer_tpu_torch.ops.packed_nc import packed_nc

    if adj.dtype != torch.int32 or adj.dim() != 2:
        raise TypeError(
            "only the bit-packed [n_pad, words] int32 adjacency is ported"
        )
    if node_mask is not None:
        colors = torch.where(node_mask, colors, -1)
    return packed_nc(adj, colors, n_col_pad_of(n_colors))


# ------------- packed A of a host graph, built on the device from its ELL -------------

# Temporaries of one row chunk of the build: its rows as an int8 strip
# [rows, 32 * words] (one byte a column) and the words they fold into.
PACK_STRIP_BYTES = 512 * 1024**2
# packed_rows_to_ids unpacks row blocks whose [block, 32 * words] int32
# intermediate stays within this bound (JAX's 48 MB,
# dense_adj.py:packed_rows_to_ids), whatever the cap
ROWS_TO_IDS_BLOCK_BYTES = 48 * 1024**2


def pack_ell_rows(neigh: torch.Tensor, n_pad: int) -> torch.Tensor:
    """An ELL row band [rows, d_pad] -> its packed adjacency rows [rows,
    words] int32, in the ``packed_bit_coords`` order: set a 0/1 int8
    strip (a set, so duplicate ids land once; ids outside [0, n_pad),
    the padding among them, go to a slot that is cut off), then fold its
    32 bit planes into words.  Column v of a window lies at strip
    position v, and the [n_k, 32, 128] view of a window puts it at (bit
    jl // 128, word jl % 128)."""
    rows_n, d_pad = neigh.shape
    words = packed_adj_words(n_pad)
    k_total = words * 32
    dev = neigh.device
    strip = torch.zeros((rows_n * k_total + 1,), dtype=torch.int8, device=dev)
    row_base = torch.arange(rows_n, dtype=torch.int64, device=dev)[:, None] * k_total
    flat = torch.where((neigh >= 0) & (neigh < n_pad), row_base + neigh, rows_n * k_total)
    strip.index_fill_(0, flat.reshape(-1), 1)
    planes = strip[:-1].view(rows_n, words // 128, 32, 128)
    out = torch.zeros((rows_n, words // 128, 128), dtype=torch.int32, device=dev)
    for b in range(32):
        out |= planes[:, :, b, :].to(torch.int32) << b  # int32 shifts wrap into bit 31
    return out.view(rows_n, words)


def build_packed_rows(neighbors: torch.Tensor, n_pad: int) -> torch.Tensor:
    """[rows, words] int32 packed rows of the ELL rows ``neighbors`` (ids
    below ``n_pad``; ``n_pad`` itself is the padding), built on their
    device by ``pack_ell_rows`` a row chunk at a time: the whole A of an
    ELL, or one rank's strip of it (``parallel/sharded.py``)."""
    rows = neighbors.shape[0]
    words = packed_adj_words(n_pad)
    chunk = max(1, PACK_STRIP_BYTES // (words * 32))
    a = torch.empty((rows, words), dtype=torch.int32, device=neighbors.device)
    for r0 in range(0, rows, chunk):
        a[r0:r0 + chunk] = pack_ell_rows(neighbors[r0:r0 + chunk], n_pad)
    return a


def build_packed_adjacency_from_ell(ell) -> torch.Tensor:
    """[n_pad, words] int32 packed adjacency built on the ELL's device from
    its rectangle."""
    return build_packed_rows(ell.neighbors, ell.n_pad)


def adjacency_nnz(adj: torch.Tensor) -> int:
    """Set bits of a packed adjacency: per-row popcounts on the device
    (at most n_pad a row, inside int32), summed exactly on the host."""
    from mcmc_colorer_tpu_torch.ops.hashgen import degrees_from_packed

    return int(degrees_from_packed(adj).cpu().numpy().astype(np.int64).sum())


def check_adjacency_complete(adj: torch.Tensor, graph) -> None:
    """The packed A is a 0/1 set: duplicate edges of an imported graph
    (kept by graph/io.py, as the reference does) collapse to one bit, and
    its conflict counts would then leave the gather paths'.  Refuse unless
    A holds exactly 2m entries."""
    refuse_multigraph(2 * graph.n_edges - adjacency_nnz(adj))


def refuse_multigraph(extra: int) -> None:
    """Raise where ``extra`` adjacency slots of the graph (its CSR entries
    less the packed rows' set bits) collapsed into bits already set."""
    if extra:
        raise ValueError(
            f"graph has duplicate edges ({extra} extra ELL "
            "slots): the packed backend's 0/1 adjacency cannot represent "
            "multigraphs; dedupe the edge list or use backend='pallas'/'xla'"
        )


def get_adjacency(graph, ell, stats=None) -> torch.Tensor:
    """The packed adjacency of a host ``Graph`` at its device ELL ``ell``'s
    n_pad, built on the ELL's device by scattering from its rows (no
    host edge array is uploaded), once per (graph, n_pad, device), and
    cached on the graph object (it dies with the graph, and two graphs
    never share one).

    Counterpart of JAX's ``get_adjacency``, packed kind only: the port's
    NC over any adjacency is kernel K1, which reads the packed layout, so
    ``backend="matmul"`` builds packed A too.  The dense int8 kind is
    ROADMAP.md Queue 1 item 8's other half.  The completeness check is
    skipped for graphs their generator certifies simple
    (``graph.simple_certified``).  ``stats`` (a dict) receives
    ``cached``, and for a build its ``build_s``, ``check_s`` and
    ``total_s``."""
    import time

    dev = ell.neighbors.device
    cache = graph.__dict__.setdefault("_adj_cache", {})
    key = (ell.n_pad, str(dev))
    stats = {} if stats is None else stats
    stats["cached"] = key in cache
    if key in cache:
        return cache[key]
    t0 = time.perf_counter()
    a = build_packed_adjacency_from_ell(ell)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    if not graph.simple_certified:
        check_adjacency_complete(a, graph)
    t2 = time.perf_counter()
    stats.update(build_s=t1 - t0, check_s=t2 - t1, total_s=t2 - t0)
    cache[key] = a
    return a


def packed_rows_to_ids(bits: torch.Tensor, d_row: int, n_pad: int) -> torch.Tensor:
    """[k, words] packed adjacency rows -> [k, d_row] int32 neighbour ids
    in ascending order, the sentinel ``n_pad`` after the last (JAX's
    ``packed_rows_to_ids``: how a frontier on a resident graph gets its
    rows without a stored ELL).  ``d_row`` >= the largest row's set bits;
    a longer row is cut to its first d_row ids, as JAX's sorted slice.

    In row blocks whose [block, 32 * words] int32 intermediate stays
    within ``ROWS_TO_IDS_BLOCK_BYTES``: a block's bits are unpacked in
    column order (the [n_k, 32, 128] view of a window's words is the
    inverse of ``packed_bit_coords``), a prefix count of set bits gives
    each set bit its slot, and one scatter writes the column ids there.
    No sort."""
    k, words = bits.shape
    k_total = words * 32
    dev = bits.device
    block = max(8, min(k, ROWS_TO_IDS_BLOCK_BYTES // max(k_total * 4, 1)))
    shifts = torch.arange(32, dtype=torch.int32, device=dev)[None, None, :, None]
    cols = torch.arange(k_total, dtype=torch.int32, device=dev)
    out = torch.empty((k, d_row), dtype=torch.int32, device=dev)
    for r0 in range(0, k, block):
        bb = bits[r0:r0 + block]
        rows_b = bb.shape[0]
        m = ((bb.view(rows_b, words // 128, 1, 128) >> shifts) & 1).view(rows_b, k_total)
        slot = torch.cumsum(m, dim=1, dtype=torch.int32) - 1
        slot = torch.where((m == 1) & (slot < d_row), slot, d_row).to(torch.int64)
        o = torch.full((rows_b, d_row + 1), n_pad, dtype=torch.int32, device=dev)
        o.scatter_(1, slot, cols.expand(rows_b, k_total))  # slot d_row is cut off
        out[r0:r0 + rows_b] = o[:, :d_row]
    return out
