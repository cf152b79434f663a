"""Plain NumPy GreedyFF and VFF, the colourings the greedy jobs must equal.

The semantics are the reference's ``coloringGreedyFF.cu`` and
``coloringVFF.cu`` as the repository's README and ``SURVEY.md`` describe
them, written here from that description over a CSR:

- GreedyFF: repeat { every uncoloured vertex takes the smallest colour
  that no coloured neighbour holds; a coloured vertex that shares its
  colour with a lower-id neighbour is uncoloured again } until every
  vertex is coloured.
- VFF: GreedyFF, then with k used colours and gamma = n // k a vertex is
  flagged while its class holds more than gamma; each round every flagged
  vertex moves to the smallest colour below k, other than its own, whose
  class holds fewer than gamma and that no neighbour holds (it stays put
  where there is none); it stays flagged iff a lower-id neighbour now
  shares its colour; the class sizes follow.  It stops when nothing is
  flagged, or when the flagged sets of ten rounds in a row are equal
  (a livelock), and then returns the GreedyFF colouring
  (coloringVFF.cu:17,232-234,323-466).
"""

from __future__ import annotations

import numpy as np


def _edges(row_ptr: np.ndarray, cols: np.ndarray):
    n = row_ptr.shape[0] - 1
    return np.repeat(np.arange(n), np.diff(row_ptr)), cols.astype(np.int64)


def _first_free(n, u_sel, src, dst, colors, width, allow=None, cur=None):
    """For each vertex in ``u_sel`` (bool [n]): the smallest colour in
    [0, width) that no neighbour holds (and ``allow`` admits, other than
    ``cur``), or -1."""
    idx = np.full(n, -1, np.int64)
    us = np.flatnonzero(u_sel)
    idx[us] = np.arange(us.size)
    used = np.zeros((us.size, width + 1), bool)
    e = u_sel[src] & (colors[dst] >= 0) & (colors[dst] < width)
    used[idx[src[e]], colors[dst[e]]] = True
    if allow is not None:
        used[:, :width] |= ~allow[None, :width]
    if cur is not None:
        c = cur[us]
        ok = (c >= 0) & (c < width)
        used[np.flatnonzero(ok), c[ok]] = True
    used[:, width] = False  # sentinel: a row with no free colour lands here
    first = used.argmin(1)
    out = np.where(first < width, first, -1)
    full = np.full(n, -1, np.int64)
    full[us] = out
    return full


def _lower_id_shared(n, src, dst, colors):
    hit = (colors[src] == colors[dst]) & (colors[src] >= 0) & (dst < src)
    return np.bincount(src[hit], minlength=n) > 0


def greedy_ff(row_ptr: np.ndarray, cols: np.ndarray) -> np.ndarray:
    n = row_ptr.shape[0] - 1
    src, dst = _edges(row_ptr, cols)
    width = int(np.diff(row_ptr).max(initial=0)) + 1
    colors = np.full(n, -1, np.int64)
    while (colors < 0).any():
        unc = colors < 0
        tentative = np.where(unc, _first_free(n, unc, src, dst, colors, width), colors)
        colors = np.where(_lower_id_shared(n, src, dst, tentative), -1, tentative)
    return colors


def vff(row_ptr: np.ndarray, cols: np.ndarray) -> np.ndarray:
    n = row_ptr.shape[0] - 1
    src, dst = _edges(row_ptr, cols)
    gff = greedy_ff(row_ptr, cols)
    k = int(gff.max(initial=-1)) + 1
    width = int(np.diff(row_ptr).max(initial=0)) + 1
    gamma = n // max(k, 1)
    bins = np.bincount(gff, minlength=width)
    flagged = gamma < bins[gff]
    colors, history = gff.copy(), []
    while flagged.any():
        allow = (bins < gamma) & (np.arange(bins.size) < k)
        cand = _first_free(n, flagged, src, dst, colors, width, allow=allow, cur=colors)
        colors = np.where(flagged & (cand >= 0), cand, colors)
        flagged = flagged & _lower_id_shared(n, src, dst, colors)
        bins = np.bincount(colors, minlength=width)
        history = (history + [flagged.copy()])[-10:]
        if len(history) == 10 and all(np.array_equal(h, history[0]) for h in history):
            return gff
    return colors
