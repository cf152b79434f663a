"""Bit-packed adjacency and the neighbour-colour counts NC = A·onehot(colors).

Counterpart of the packed part of ``mcmc_colorer_tpu/ops/dense_adj.py``.
A is stored as ``torch.int32`` words holding the uint32 bit patterns of
the JAX package's ``[n_pad, words]`` uint32 array, in the same
``packed_bit_coords`` order: within each ``PACKED_K_CHUNK``-wide column
window, column ``jl`` lives in word ``jl % 128`` at bit ``jl // 128``.
``(x >> b) & 1`` reads bit ``b`` correctly under torch's arithmetic shift.
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
