"""The hash-defined G(n, p), derived again from its definition.

Frozen copy of the definition in ``mcmc_colorer_tpu_torch/ops/hashgen.py``
(module docstring, ``er_threshold`` at lines 46-48, ``_mix`` at 57-65,
the murmur3 fmix32 constants at 33-37):

    edge(i, j)  :=  mix32(seed, min(i, j), max(i, j)) < floor(p * 2**32),   i != j

written here independently over int64 tensors holding uint32 values
(masked to 32 bits after each multiply), where the program under test
works on int32 bit patterns.  The packed word layout that the program's
adjacency is judged in is the frozen copy of
``ops/dense_adj.py:packed_bit_coords`` (lines 67-72): column j sits in
word (j // 4096) * 128 + j % 128, bit (j % 4096) // 128.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_C1, _C2, _C3, _GOLD = 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x9E3779B9


def threshold(p: float) -> int:
    """floor(p * 2**32), clipped to the uint32 range."""
    return min(_M32, max(0, int(p * 4294967296.0)))


def mix32(seed: int, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """mix32(seed, lo, hi) as uint32 values in int64 tensors."""
    h = ((lo ^ ((seed & _M32) ^ _GOLD)) * _C1) & _M32
    h = h ^ (h >> 13)
    h = ((h ^ hi) * _C2) & _M32
    h = h ^ (h >> 16)
    h = (h * _C3) & _M32
    return h ^ (h >> 15)


def hash_edges(n: int, p: float, seed: int, device, band: int = 256):
    """(src, dst) int32 tensors on ``device``: every edge (i < j) of the
    hash graph, row-major, derived in bands of ``band`` rows."""
    t = threshold(p)
    src, dst = [], []
    for r0 in range(0, n - 1, band):
        r1 = min(n - 1, r0 + band)
        rows = torch.arange(r0, r1, dtype=torch.int64, device=device)[:, None]
        cols = torch.arange(r0 + 1, n, dtype=torch.int64, device=device)[None, :]
        edge = (mix32(seed, rows, cols) < t) & (cols > rows)
        i, j = edge.nonzero(as_tuple=True)
        src.append((i + r0).to(torch.int32))
        dst.append((j + r0 + 1).to(torch.int32))
    if not src:
        empty = torch.zeros((0,), dtype=torch.int32, device=device)
        return empty, empty
    return torch.cat(src), torch.cat(dst)


def degrees(src: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """[n] int64 degrees of an undirected edge list."""
    return (torch.bincount(src.long(), minlength=n)
            + torch.bincount(dst.long(), minlength=n))


def word_bit(j: torch.Tensor):
    """Column j -> (word, bit) of the packed layout (module docstring)."""
    return (j // 4096) * 128 + j % 128, (j % 4096) // 128


def popcount_words(words: torch.Tensor, band: int = 4096) -> int:
    """Set bits of an int32 tensor of uint32 patterns, summed."""
    total = 0
    flat = words.reshape(-1)
    step = band * 4096
    for k in range(0, flat.numel(), step):
        x = flat[k:k + step].to(torch.int64) & _M32
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        total += int(((x * 0x01010101) & _M32).__rshift__(24).sum())
    return total


def adjacency_wrong_bits(words: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                         chunk: int = 1 << 24) -> int:
    """Bits in which the packed adjacency ``words`` ([rows, words] int32)
    differs from the edge list: the edge bits it lacks (both directions
    of each edge) plus the set bits that are no edge."""
    missing = 0
    for k in range(0, src.numel(), chunk):
        s, d = src[k:k + chunk].long(), dst[k:k + chunk].long()
        for a, b in ((s, d), (d, s)):
            w, bit = word_bit(b)
            got = (words[a, w].to(torch.int64) >> bit) & 1
            missing += int((got == 0).sum())
    present = 2 * src.numel() - missing
    return missing + (popcount_words(words) - present)
