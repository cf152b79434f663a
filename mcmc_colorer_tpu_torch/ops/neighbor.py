"""Neighbour-colour gathers, occupancy and the colour-class histogram.

Counterpart of ``mcmc_colorer_tpu/ops/neighbor.py``: ``extend_colors``,
``neighbor_colors``, ``occupancy_matrix`` and ``color_histogram``.
``take_rows`` (the frontier gather) waits for the frontier slice.
"""

from __future__ import annotations

import torch


def extend_colors(colors: torch.Tensor, fill: int = -1) -> torch.Tensor:
    """Append one sentinel slot so ELL padding gathers land on ``fill``."""
    tail = torch.full((1,), fill, dtype=torch.int32, device=colors.device)
    return torch.cat([colors.to(torch.int32), tail])


def neighbor_colors(
    neighbors: torch.Tensor, colors: torch.Tensor, fill: int = -1
) -> torch.Tensor:
    """[B, d_pad] colours of each vertex's neighbours; padding slots (the
    sentinel id ``len(colors)``) get ``fill``.  ``colors`` covers every id
    in ``neighbors``.  ``index_select`` takes the int32 ids as they are,
    without an int64 copy of the index."""
    ext = extend_colors(colors, fill)
    return ext.index_select(0, neighbors.reshape(-1)).reshape(neighbors.shape)


def occupancy_matrix(neigh_cols: torch.Tensor, n_colors: int) -> torch.Tensor:
    """[B, n_colors] bool: occ[v, c] iff some neighbour of v has colour c.
    Colours < 0 (padding) and >= n_colors (phantoms) are dropped: they
    scatter into one extra column that is cut off."""
    b = neigh_cols.shape[0]
    idx = torch.where(
        (neigh_cols >= 0) & (neigh_cols < n_colors), neigh_cols, n_colors
    ).to(torch.int64)
    occ = torch.zeros((b, n_colors + 1), dtype=torch.bool, device=neigh_cols.device)
    occ.scatter_(1, idx, True)
    return occ[:, :n_colors]


def color_histogram(
    colors: torch.Tensor, n_colors: int, node_mask: torch.Tensor | None = None
) -> torch.Tensor:
    """[n_colors] int32 class sizes.  Colours outside the palette and
    vertices outside ``node_mask`` (phantom padding) are dropped."""
    keep = (colors >= 0) & (colors < n_colors)
    if node_mask is not None:
        keep &= node_mask
    return torch.bincount(colors[keep], minlength=n_colors).to(torch.int32)
