"""The benchmark's own seeded Barabási–Albert edge list (Barabási & Albert,
Science 286:509, 1999).

The model is the program's native sampler's (``native/importer.cpp``,
``mc_generate_ba``), written here again: an (m+1)-clique seeds the
graph; then each new vertex v, in order, joins m distinct earlier
vertices, each drawn uniformly from the stub list (every endpoint of
every edge so far, after one stub of each clique vertex), a draw that
repeats one of v's targets drawn again; its m edges then add (v, t) to
the stub list for each target t.  NumPy's PCG64 is seeded by the whole
seed, as ``er_edges.py`` does, so any whole number seeds it.

No loop over the vertices: the stub list's length before vertex v is
fixed by v alone, so every draw is a position in that list, drawn at
once.  A position names either a vertex outright (a clique stub, or the
first stub of a pair, which is the new vertex itself) or an earlier
draw (the second stub of a pair, which is that draw's target), and the
draws resolve by pointer jumping (Batagelj & Brandes, Phys. Rev. E 71,
036113, 2005).  Then the draws that repeat a target of their vertex are
drawn again and everything resolves anew, until none repeats.
"""

from __future__ import annotations

import numpy as np


def _resolve(direct: np.ndarray, ptr: np.ndarray) -> np.ndarray:
    """Each draw's target: ``direct`` where it is >= 0, else the target of
    draw ``ptr`` (always an earlier one), by pointer jumping."""
    val = direct.copy()
    nxt = ptr.copy()
    todo = np.flatnonzero(val < 0)
    while todo.size:
        p = nxt[todo]
        got = val[p]
        done = got >= 0
        val[todo[done]] = got[done]
        todo = todo[~done]
        nxt[todo] = nxt[p[~done]]
    return val


def _repeats(targets: np.ndarray, m: int, rows: np.ndarray | None = None) -> np.ndarray:
    """Flat indices of the draws that repeat an earlier draw of the same
    vertex (``targets`` flat, m a vertex; only the vertices ``rows`` where
    given): the first of equal draws stays."""
    t = targets.reshape(-1, m)
    if rows is not None:
        t = t[rows]
    rep = np.zeros(t.shape, dtype=bool)
    for j in range(1, m):
        for i in range(j):
            rep[:, j] |= t[:, j] == t[:, i]
    r, c = np.nonzero(rep)
    return (r if rows is None else rows[r]) * m + c


def _parse(pos: np.ndarray, head: np.ndarray, m0: int, m: int):
    """(direct, ptr) of stub positions: a head stub's vertex, or a pair's
    first stub's vertex (the new vertex itself), directly; a pair's second
    stub by the draw it holds the target of."""
    s0 = head.size
    q = pos - s0
    pair = q >= 0
    own = pair & (q % 2 == 0)
    direct = np.where(pair, np.where(own, m0 + q // (2 * m), -1),
                      head[np.clip(pos, 0, s0 - 1)]).astype(np.int32)
    return direct, np.where(pair & ~own, q // 2, 0).astype(np.int32)


def ba_edges(n: int, m: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) int32 arrays of BA(n, m): the clique's edges (src < dst),
    then each new vertex's m edges (src = the new vertex, dst its
    targets, in the order drawn).  A simple graph of
    m(m+1)/2 + (n - m - 1)·m edges."""
    if m < 1 or n <= m:
        raise ValueError("need n > m >= 1")
    rng = np.random.Generator(np.random.PCG64(seed))
    m0 = m + 1
    ci, cj = np.triu_indices(m0, k=1)
    # the stub list's head: one stub a clique vertex, then both ends of each clique edge
    head = np.concatenate([np.arange(m0), np.stack([ci, cj], 1).reshape(-1)]).astype(np.int32)
    k = n - m0
    v_of = np.repeat(np.arange(k, dtype=np.int64), m)    # new vertex index of each draw
    length = head.size + 2 * m * v_of                    # stubs before that vertex
    pos = rng.integers(0, length).astype(np.int32)
    targets = _resolve(*_parse(pos, head, m0, m))
    rep = _repeats(targets, m)
    while rep.size:
        # draw the repeats again until their vertices repeat nothing, each
        # read through the current targets; then resolve the whole list,
        # since draws that point at a changed one change too
        while rep.size:
            pos[rep] = rng.integers(0, length[rep])
            direct, ptr = _parse(pos[rep], head, m0, m)
            targets[rep] = np.where(direct >= 0, direct, targets[ptr])
            rep = _repeats(targets, m, np.unique(rep // m))
        targets = _resolve(*_parse(pos, head, m0, m))
        rep = _repeats(targets, m)
    src = np.concatenate([ci, m0 + v_of]).astype(np.int32)
    dst = np.concatenate([cj, targets]).astype(np.int32)
    return src, dst
