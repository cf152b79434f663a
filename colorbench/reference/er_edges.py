"""The benchmark's own seeded G(n, p) edge list.

Exact G(n, p): the number of edges is drawn from Binomial(n(n-1)/2, p),
then that many distinct pairs uniformly from the n(n-1)/2 pairs (i < j),
with NumPy's PCG64 seeded by the whole seed, so any whole number seeds
it.  Both the program under test (through its edge-list path) and the
reference read the same arrays.
"""

from __future__ import annotations

import numpy as np


def er_edges(n: int, p: float, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) int32 arrays, src < dst, sorted row-major."""
    rng = np.random.Generator(np.random.PCG64(seed))
    pairs = n * (n - 1) // 2
    m = int(rng.binomial(pairs, p)) if pairs else 0
    k = np.sort(rng.choice(pairs, size=m, replace=False)) if m else np.zeros(0, np.int64)
    # row i starts at offset i * (2n - i - 1) / 2 of the row-major upper triangle
    i = np.arange(n, dtype=np.int64)
    starts = i * (2 * n - i - 1) // 2
    src = np.searchsorted(starts, k, side="right") - 1
    dst = k - starts[src] + src + 1
    return src.astype(np.int32), dst.astype(np.int32)


def csr(n: int, src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(row_ptr, cols) of the undirected graph, each row's ids ascending."""
    a = np.concatenate([src, dst]).astype(np.int64)
    b = np.concatenate([dst, src]).astype(np.int64)
    order = np.lexsort((b, a))
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(a, minlength=n), out=row_ptr[1:])
    return row_ptr, b[order].astype(np.int32)
