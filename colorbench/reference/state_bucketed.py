"""The program's degree-bucketed layout judged against the reference's
edges, as the sorted keys a·n + b of every slot of every class, each end
mapped back to the input's ids by the driver (a slot whose row or id
names no real vertex holds the invalid key -1): the keys missing on
either side, counted as multisets, so that a repeated slot counts too.

Plain torch on the judge's device (the edges'), over int64, a band of
rows at a time: the reference's keys of a band come from one sort of the
band's directed edges (``state_ell.band_keys``: both directions of each
edge whose end a lies in the band); the program's keys of the band are a
range of its sorted keys.  Memory beyond the edges and the keys scales
with the band.
"""

import torch

from colorbench.reference.state_ell import band_keys

BAND_KEYS = 1 << 24  # about the program's keys in a band of rows


def _missing(got: torch.Tensor, want: torch.Tensor) -> int:
    """The multiset difference of two sorted int64 tensors, both ways:
    each key of ``got`` against ``want``'s count of it, then ``want``'s
    keys that ``got`` lacks altogether."""
    ug, cg = torch.unique_consecutive(got, return_counts=True)
    uw, cw = torch.unique_consecutive(want, return_counts=True)
    matched = torch.zeros_like(cg)
    if uw.numel():
        at = torch.searchsorted(uw, ug).clamp_(max=uw.numel() - 1)
        matched = torch.where(uw[at] == ug, cw[at], 0)
    return int((cg - matched).abs().sum()) + int(cw.sum() - matched.sum())


def errors(keys, src, dst, n: int) -> int:
    dev = src.device
    keys = keys.to(device=dev, dtype=torch.int64)
    lo = int(torch.searchsorted(keys, torch.tensor(0, dtype=torch.int64, device=dev)))
    hi = int(torch.searchsorted(keys, torch.tensor(n * n, dtype=torch.int64, device=dev)))
    bad = lo + (keys.numel() - hi)  # the invalid keys, and any beyond the last row
    band = max(1, n * BAND_KEYS // max(keys.numel(), 1))
    for r0 in range(0, n, band):
        r1 = min(n, r0 + band)
        a, b = (int(x) for x in torch.searchsorted(
            keys, torch.tensor([r0 * n, r1 * n], dtype=torch.int64, device=dev)))
        bad += _missing(keys[a:b], band_keys(src, dst, n, r0, r1))
    return bad
