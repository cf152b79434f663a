"""The program's ELL rows judged against the reference's edges: the rows
whose neighbour ids, sorted, differ (padding is any id >= n), plus the
rows whose degree exceeds the ELL's width.

Plain torch on the judge's device (the edges'), over int64, a band of
rows at a time: the reference's rows of a band come from one sort of the
keys a·n + b of the band's directed edges (both directions of each edge
whose end a lies in the band), so that row a's ids are its keys' b in
ascending order; the program's rows of the band are sorted beside them.
Memory beyond the edges scales with the band, not with 2·E.
"""

import torch

BAND_ELEMENTS = 1 << 26  # ids in a band of the program's rows (int64: 512 MB a temporary)


def band_keys(src: torch.Tensor, dst: torch.Tensor, n: int, r0: int, r1: int) -> torch.Tensor:
    """int64, sorted: a·n + b for every edge (a, b) in either direction
    whose a lies in rows [r0, r1)."""
    parts = []
    for a, b in ((src, dst), (dst, src)):
        m = (a >= r0) & (a < r1)
        parts.append(a[m].to(torch.int64).mul_(n).add_(b[m]))
        del m
    return torch.sort(torch.cat(parts)).values


def errors(neighbors, src, dst, n: int) -> int:
    dev = src.device
    width = neighbors.shape[1]
    band = max(1, BAND_ELEMENTS // max(width, 1))
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    for r0 in range(0, n, band):
        r1 = min(n, r0 + band)
        keys = band_keys(src, dst, n, r0, r1)
        row_ptr = torch.searchsorted(
            keys, torch.arange(r0, r1 + 1, dtype=torch.int64, device=dev) * n)
        fits = (row_ptr[1:] - row_ptr[:-1]) <= width
        row = torch.div(keys, n, rounding_mode="floor")
        pos = torch.arange(keys.numel(), dtype=torch.int64, device=dev) - row_ptr[row - r0]
        keep = pos < width
        want = torch.full((r1 - r0, width), n, dtype=torch.int64, device=dev)
        want[row[keep] - r0, pos[keep]] = keys[keep] - row[keep] * n
        del keys, row, pos, keep
        got = neighbors[r0:r1].to(device=dev, dtype=torch.int64).clamp_(max=n)
        got = torch.sort(got, dim=1).values
        bad += ((got != want).any(1) | ~fits).sum()
    return int(bad)
