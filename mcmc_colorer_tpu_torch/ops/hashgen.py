"""Hash-defined G(n, p), materialised on the device as a bit-packed adjacency.

Counterpart of ``mcmc_colorer_tpu/ops/hashgen.py``.  The edge set is a
function of (seed, i, j):

    edge(i, j)  :=  mix32(seed, min(i, j), max(i, j)) < floor(p * 2**32)

so the device builds A without any upload, and the host's C++ enumerator
(``native/importer.cpp:mc_generate_er_hash``) derives the same graph for
checking.  The words equal the JAX package's uint32 words bit for bit.
On a mesh (``parallel/mesh.py``) each rank builds only its own rows, its
strip of A (``er_packed_strips_on_device``), and the degrees come from a
pass that never holds A (``er_degrees_on_device``).

Every generator goes through ``_gen_packed_rows``, which dispatches on the
device: a CUDA tensor goes to kernel K6 (``ops/hash_packed.py``,
``csrc/hash_packed.cu``), one launch for any window of rows, the words
and the degrees together; a CPU tensor to the plain version
(``gen_packed_rows_plain``: the torch ops below, a band of rows at a
time).  There is no fallback from the card to the plain version.

torch has no logical right shift and no unsigned compare for 32-bit
integers, so the mixer works on ``int32`` tensors holding uint32 bit
patterns:

- multiplies wrap modulo 2**32 in int32 exactly as in uint32 (the low
  32 bits of a product do not depend on signedness);
- a logical shift is the arithmetic shift with the sign-extended bits
  masked off;
- ``h < t`` unsigned is ``(h ^ 0x80000000) < (t ^ 0x80000000)`` signed.
"""

from __future__ import annotations

import numpy as np
import torch

from mcmc_colorer_tpu_torch.models.base import colorer_device
from mcmc_colorer_tpu_torch.ops import hash_packed as k6
from mcmc_colorer_tpu_torch.ops.dense_adj import PACKED_K_CHUNK, packed_adj_words

# murmur3 fmix32 constants (public domain)
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_C3 = 0x27D4EB2F
_GOLD = 0x9E3779B9
_SIGN = 0x80000000


def _i32(x: int) -> int:
    """uint32 value -> the int32 with the same bit pattern."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x & _SIGN else x


def er_threshold(p: float) -> int:
    """uint32 acceptance threshold for Bernoulli(p)."""
    return min(0xFFFFFFFF, max(0, int(p * 4294967296.0)))


def _srl(h: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns."""
    return (h >> s) & ((1 << (32 - s)) - 1)


def _mix(seed: int, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """mix32(seed, i, j) on int32 tensors of uint32 bit patterns."""
    h = (i ^ _i32(seed ^ _GOLD)) * _i32(_C1)
    h = h ^ _srl(h, 13)
    h = (h ^ j) * _i32(_C2)
    h = h ^ _srl(h, 16)
    h = h * _i32(_C3)
    return h ^ _srl(h, 15)


def hash_edges_reference(n: int, p: float, seed: int) -> np.ndarray:
    """Host numpy enumeration of the hash graph's upper-triangle edges
    (i < j), in row-major order: the small-n oracle."""
    t = np.uint32(er_threshold(p))
    i, j = np.triu_indices(n, k=1)
    i32, j32 = i.astype(np.uint32), j.astype(np.uint32)
    with np.errstate(over="ignore"):
        h = np.uint32(seed & 0xFFFFFFFF) ^ np.uint32(_GOLD)
        h = (h ^ i32) * np.uint32(_C1)
        h ^= h >> np.uint32(13)
        h = (h ^ j32) * np.uint32(_C2)
        h ^= h >> np.uint32(16)
        h = h * np.uint32(_C3)
        h ^= h >> np.uint32(15)
    keep = h < t
    return np.stack([i[keep], j[keep]], axis=1)


def _plain_band(
    r0: int, n: int, t: int, seed32: int, row_chunk: int, words: int,
    out: torch.Tensor,
) -> None:
    """Writes rows [r0, r0 + row_chunk) of the packed adjacency into
    ``out`` ([row_chunk, words] int32).  Word w (window w // 128, lane
    w % 128) bit b holds column (w // 128) * 4096 + b * 128 + w % 128."""
    dev = out.device
    rows = r0 + torch.arange(row_chunk, dtype=torch.int32, device=dev)[:, None]
    w = torch.arange(words, dtype=torch.int32, device=dev)[None, :]
    j_base = (w // 128) * PACKED_K_CHUNK + w % 128
    t_flip = _i32(t ^ _SIGN)
    out.zero_()
    for b in range(32):
        j = j_base + 128 * b
        lo = torch.minimum(rows, j)
        hi = torch.maximum(rows, j)
        edge = (
            ((_mix(seed32, lo, hi) ^ _i32(_SIGN)) < t_flip)
            & (rows != j)
            & (j < n)
            & (rows < n)
        )
        out |= edge.to(torch.int32) << b  # in place: accumulates the 32 bits


def gen_packed_rows_plain(
    r0: int, n: int, t: int, seed32: int, words: int, out: torch.Tensor | None = None,
    degrees: torch.Tensor | None = None, row_chunk: int = 2048,
) -> None:
    """Plain version of K6, on any device: rows [r0, r0 + rows) of the
    packed adjacency into ``out`` ([rows, words] int32) and their degrees
    into ``degrees`` ([rows] int32), either of which may be None, in
    bands of ``row_chunk`` rows (without ``out`` each band is popcounted
    and thrown away, so A is never held)."""
    rows = (out if out is not None else degrees).shape[0]
    dev = (out if out is not None else degrees).device
    band = None
    if out is None:
        band = torch.empty((min(row_chunk, rows), words), dtype=torch.int32, device=dev)
    for b0 in range(0, rows, row_chunk):
        b1 = min(rows, b0 + row_chunk)
        dst = out[b0:b1] if out is not None else band[:b1 - b0]
        _plain_band(r0 + b0, n, t, seed32, b1 - b0, words, dst)
        if degrees is not None:
            degrees[b0:b1] = popcount32(dst).sum(1, dtype=torch.int32)


def _gen_packed_rows(
    r0: int, n: int, t: int, seed32: int, words: int, out: torch.Tensor | None = None,
    degrees: torch.Tensor | None = None, row_chunk: int = 2048,
) -> None:
    """Rows [r0, r0 + rows) of the packed adjacency into ``out`` and/or
    their degrees into ``degrees``: K6 in one launch on CUDA (raising on
    what it does not take), the plain version on the CPU."""
    dev = (out if out is not None else degrees).device
    if dev.type == "cuda":
        k6.hash_packed_cuda(r0, n, t, seed32, out, degrees)
    elif dev.type == "cpu":
        gen_packed_rows_plain(r0, n, t, seed32, words, out, degrees, row_chunk)
    else:
        raise ValueError(f"no hash generator for device {dev}")


def _er_packed(n, p, seed, n_pad, row_chunk, device, with_degrees: bool):
    device = colorer_device(device)
    if n_pad % row_chunk:
        raise ValueError(f"row_chunk must divide n_pad ({n_pad})")
    if n > n_pad:
        raise ValueError(f"n={n} exceeds n_pad={n_pad}")
    words = packed_adj_words(n_pad)
    adj = torch.empty((n_pad, words), dtype=torch.int32, device=device)
    degrees = torch.empty((n_pad,), dtype=torch.int32, device=device) if with_degrees else None
    _gen_packed_rows(0, n, er_threshold(p), seed & 0xFFFFFFFF, words, adj, degrees, row_chunk)
    return adj, degrees


def er_packed_on_device(
    n: int, p: float, seed: int, n_pad: int, row_chunk: int = 2048,
    device="cuda",
) -> torch.Tensor:
    """[n_pad, words] int32 bit-packed adjacency of the hash graph, built
    on ``device`` (the current card by default, raising without one:
    ``models/base.colorer_device``): one K6 launch on the card, bands of
    ``row_chunk`` rows on the CPU."""
    return _er_packed(n, p, seed, n_pad, row_chunk, device, with_degrees=False)[0]


def er_packed_and_degrees(
    n: int, p: float, seed: int, n_pad: int, row_chunk: int = 2048,
    device="cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(A as :func:`er_packed_on_device` builds it, its [n_pad] int32
    degrees): K6 writes both in one launch on the card."""
    return _er_packed(n, p, seed, n_pad, row_chunk, device, with_degrees=True)


def er_packed_plain(
    n: int, p: float, seed: int, n_pad: int, row_chunk: int = 2048, device="cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(A, degrees) of :func:`er_packed_and_degrees` from the plain version
    on any ``device`` (the CPU unless asked): what K6 is held against on
    the card."""
    device = torch.device(device)
    words = packed_adj_words(n_pad)
    adj = torch.empty((n_pad, words), dtype=torch.int32, device=device)
    degrees = torch.empty((n_pad,), dtype=torch.int32, device=device)
    gen_packed_rows_plain(0, n, er_threshold(p), seed & 0xFFFFFFFF, words, adj, degrees,
                          row_chunk)
    return adj, degrees


_PACKED_CACHE: dict = {}


def er_packed_on_device_cached(
    n: int, p: float, seed: int, n_pad: int, row_chunk: int = 2048,
    device="cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-slot cache over :func:`er_packed_and_degrees` (on the same
    default device), so colorers of the same hash graph share one device
    adjacency: (A, degrees), built together."""
    device = colorer_device(device)
    ck = (n, float(p), int(seed), n_pad, str(device))
    if ck not in _PACKED_CACHE:
        _PACKED_CACHE.clear()  # free the old graph before building the new one
        _PACKED_CACHE[ck] = er_packed_and_degrees(n, p, seed, n_pad, row_chunk, device=device)
    return _PACKED_CACHE[ck]


def er_packed_strips_on_device(
    n: int, p: float, seed: int, n_pad: int, mesh, row_chunk: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's strip of the hash graph's packed adjacency, rows
    ``[s·n_loc, (s+1)·n_loc)`` of the [n_pad, words] A, ``n_loc = n_pad /
    shards`` and s the rank's shard, and those rows' [n_loc] int32
    degrees, built together on the mesh's device (one K6 launch on the
    card, bands of ``row_chunk`` rows on the CPU), so nothing is uploaded
    and nothing crosses the mesh (JAX ``er_packed_strips_on_device``,
    whose shard s holds the same words, and returns no degrees)."""
    ms = mesh.shards
    if n_pad % ms:
        raise ValueError(f"shards must divide n_pad ({n_pad})")
    if n > n_pad:
        raise ValueError(f"n={n} exceeds n_pad={n_pad}")
    n_loc = n_pad // ms
    words = packed_adj_words(n_pad)
    strip = torch.empty((n_loc, words), dtype=torch.int32, device=mesh.device)
    degrees = torch.empty((n_loc,), dtype=torch.int32, device=mesh.device)
    _gen_packed_rows(mesh.shard_index * n_loc, n, er_threshold(p), seed & 0xFFFFFFFF, words,
                     strip, degrees, row_chunk)
    return strip, degrees


def er_degrees_on_device(
    n: int, p: float, seed: int, row_chunk: int = 2048, mesh=None, device="cuda",
) -> torch.Tensor:
    """[n] int32 degrees of the hash graph, the adjacency never held: K6
    writing degrees alone on the card, [row_chunk, words] bands popcounted
    and thrown away on the CPU (JAX ``er_degrees_on_device``: how a
    sharded colorer resolves ``n_colors = max degree`` before it builds
    its strips).  With ``mesh`` each rank
    takes its share of the rows, as JAX's shards do, on the mesh's device,
    and one all-gather over its shard group puts every degree on every
    rank; without, ``device`` (the current card by default) takes them
    all."""
    words = packed_adj_words(n)
    t, seed32 = er_threshold(p), seed & 0xFFFFFFFF
    if mesh is None:
        dev, r_base, rows_total = colorer_device(device), 0, n
    else:
        rows_total = -(-n // (mesh.shards * row_chunk)) * row_chunk  # rows a shard
        dev, r_base = mesh.device, mesh.shard_index * rows_total
    deg = torch.empty((rows_total,), dtype=torch.int32, device=dev)
    _gen_packed_rows(r_base, n, t, seed32, words, degrees=deg, row_chunk=row_chunk)
    if mesh is not None:
        deg = mesh.all_gather_shards(deg)
    return deg[:n]


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns (SWAR; torch has no
    integer popcount).  The masks keep bit 31 clear, so the arithmetic
    shifts are safe."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return _srl(x * 0x01010101, 24)


def degrees_from_packed(adj: torch.Tensor, row_chunk: int = 8192) -> torch.Tensor:
    """[n_pad] int32 per-row popcount of the packed adjacency, in row
    bands so the temporaries stay small."""
    out = torch.empty((adj.shape[0],), dtype=torch.int32, device=adj.device)
    for r0 in range(0, adj.shape[0], row_chunk):
        blk = adj[r0:r0 + row_chunk]
        out[r0:r0 + blk.shape[0]] = popcount32(blk).sum(1, dtype=torch.int32)
    return out


def hash_er_graph(n: int, p: float, seed: int, name: str | None = None):
    """Host CSR of the same hash graph from the threaded C++ enumerator
    (JAX ``hash_er_graph``), certified simple: the enumerator emits each
    pair (i < j) once, so ``get_adjacency`` and the strips skip their
    completeness checks.  Unlike JAX there is no numpy fallback: a failed
    native build raises (``graph/native.py``); ``hash_edges_reference``
    stays the tests' oracle.  O(n²) hashes on the host."""
    from mcmc_colorer_tpu_torch.graph.native import generate_er_hash

    g = generate_er_hash(n, er_threshold(p), seed & 0xFFFFFFFF, name=name or f"er_hash_{n}_{p}")
    g.simple_certified = True
    return g
