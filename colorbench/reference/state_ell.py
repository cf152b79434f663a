"""The program's ELL rows judged against the reference's edges: the rows
whose neighbour ids, sorted, differ (padding is any id >= n)."""

import numpy as np

from colorbench.reference.er_edges import csr


def errors(neighbors, src, dst, n: int) -> int:
    rows = neighbors[:n].cpu().numpy().astype(np.int64)
    rows = np.sort(np.where(rows >= n, n, rows), axis=1)
    row_ptr, cols = csr(n, src.cpu().numpy(), dst.cpu().numpy())
    width = rows.shape[1]
    deg = np.diff(row_ptr)
    want = np.full((n, max(width, 1)), n, np.int64)
    fits = deg <= width
    r = np.repeat(np.arange(n), deg)
    k = np.arange(cols.size) - np.repeat(row_ptr[:-1], deg)
    keep = fits[r]
    want[r[keep], k[keep]] = cols[keep]
    return int(((rows != want[:, :width]).any(1) | ~fits).sum())
