"""Neighbour-colour gathers, occupancy and the colour-class histogram.

Counterpart of ``mcmc_colorer_tpu/ops/neighbor.py``: ``extend_colors``,
``neighbor_colors``, ``occupancy_matrix``, ``take_rows`` (the frontier
gather, flat or degree-bucketed) and ``color_histogram``.
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


def neighbor_colors_chains(
    neighbors: torch.Tensor, colors: torch.Tensor, fill: int = -1
) -> torch.Tensor:
    """``neighbor_colors`` for a chain axis: colours [C, n] ->
    [C, B, d_pad], one gather for every chain."""
    tail = torch.full((colors.shape[0], 1), fill, dtype=torch.int32, device=colors.device)
    ext = torch.cat([colors.to(torch.int32), tail], dim=1)
    return ext.index_select(1, neighbors.reshape(-1)).reshape(colors.shape[0],
                                                              *neighbors.shape)


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


def take_rows(ell, ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[cap, d_out] int32 adjacency rows of the padded vertex ids ``ids``,
    a fresh contiguous tensor; every slot of an invalid row holds the
    sentinel ``ell.n_pad``.  On the flat ELL one ``index_select``
    (d_out = d_pad).  On the degree-bucketed layout each rectangle's rows
    are gathered at its own width d_b and written into the first d_b
    columns of the rows whose id lies in it; the rest stays the sentinel
    (d_out = the widest class).  This one helper composes every frontier
    colorer with the bucketed layout."""
    n_pad = ell.n_pad
    ids_c = ids.clamp(max=n_pad - 1)
    slices = getattr(ell, "slices", None)
    if slices is None:
        rows = ell.neighbors.index_select(0, ids_c)
        return torch.where(valid[:, None], rows, n_pad)
    d_out = max(s.d_pad for s in slices)
    out = torch.full((ids.shape[0], d_out), n_pad, dtype=torch.int32, device=ids.device)
    for s in slices:
        local = ids_c - s.start
        in_s = valid & (local >= 0) & (local < s.h_pad)
        rows = s.neighbors.index_select(0, local.clamp(0, s.h_pad - 1))
        head = out[:, : s.d_pad]
        head.copy_(torch.where(in_s[:, None], rows, head))
    return out


def frontier_ids(mask: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids, valid): the indices of ``mask``'s set entries in ascending
    order, padded to ``cap`` with the sentinel ``len(mask)`` (JAX's
    ``jnp.nonzero(mask, size=cap, fill_value=n_pad)``; entries past
    ``cap`` are cut, as there)."""
    n_pad = mask.shape[0]
    dev = mask.device
    # without a host read (torch.nonzero waits for its count): a set
    # entry's rank is its slot; the rest write to slots past cap, cut off
    rank = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    pos = torch.arange(n_pad, dtype=torch.int32, device=dev)
    slot = torch.where(mask & (rank < cap), rank, cap + pos).to(torch.int64)
    ids = torch.full((cap + n_pad,), n_pad, dtype=torch.int32, device=dev)
    ids = ids.scatter_(0, slot, pos)[:cap]
    return ids, ids < n_pad


def scatter_drop(dst: torch.Tensor, ids: torch.Tensor, values,
                 accumulate: bool = False) -> torch.Tensor:
    """A copy of ``dst`` with ``dst[ids] = values`` (``+= values`` with
    ``accumulate``), where ids equal to ``len(dst)`` are dropped: JAX's
    ``.at[ids].set(values, mode="drop")`` / ``.add`` for the sentinel of
    ``frontier_ids``.  The write goes through one extra slot that is cut
    off.  ``values`` is a tensor like ``ids`` or a scalar."""
    ext = torch.cat([dst, dst.new_zeros((1,))])
    values = torch.as_tensor(values, dtype=dst.dtype, device=dst.device)
    if accumulate:
        # index_add_ adds with atomics; index_put_(accumulate=True) would
        # sort the ids first (~20 ms at 1M ids on an H100)
        ext.index_add_(0, ids, values.expand(ids.shape))
    else:
        ext.index_put_((ids.to(torch.int64),), values)
    return ext[:-1]


def color_histogram(
    colors: torch.Tensor, n_colors: int, node_mask: torch.Tensor | None = None
) -> torch.Tensor:
    """[n_colors] int32 class sizes.  Colours outside the palette and
    vertices outside ``node_mask`` (phantom padding) are dropped: they
    add into one extra bin that is cut off (a masked index and CUDA's
    ``bincount`` would each wait for a host read)."""
    keep = (colors >= 0) & (colors < n_colors)
    if node_mask is not None:
        keep &= node_mask
    idx = torch.where(keep, colors, n_colors)
    hist = torch.zeros((n_colors + 1,), dtype=torch.int32, device=colors.device)
    hist.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return hist[:n_colors]
