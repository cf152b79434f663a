"""Graph containers: host CSR and the padded neighbour-list (ELL) layout.

Counterpart of ``mcmc_colorer_tpu/graph/container.py``: ``Graph`` (host
CSR over dense int ids, both directions of every undirected edge in
``cols``, self-loops dropped), ``degree_pad_for``, the flat ``to_ell``
and ``EllGraph``.  The ELL is ``neighbors[n_pad, d_pad]`` int32 on a
torch device, with the sentinel ``n_pad`` in every padding slot, so a
gather through a colour vector extended by one slot lands on an
always-invalid colour.

The degree-bucketed layout (``to_ell_bucketed``, ``BucketedEll``) groups
the vertices of a degree-monotonic graph (``degree_relabel``) into a few
contiguous degree classes, each one rectangle padded to its own width,
built on the host as JAX builds it and moved to the device one
contiguous int32 tensor a class.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from mcmc_colorer_tpu_torch.utils.spans import span

# The host build materialises row and slot ids for every stored edge as
# int64 (three 2m-long arrays: 24 GB at ER(1M, 0.001)) and then uploads
# the whole rectangle; on a CUDA device a rectangle above this size is
# scattered on the card from the O(2m + n) CSR upload instead
# (ops/ell_build.py).
DEVICE_BUILD_MIN_BYTES = 64 * 1024**2


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _layout_device(device) -> torch.device:
    """A layout's device: ``models/base.colorer_device`` (the current card
    for ``"cuda"`` or None, raising without one)."""
    from mcmc_colorer_tpu_torch.models.base import colorer_device

    return colorer_device(device)


def _cached_ell(cache: dict, key: tuple, build):
    """``cache[key]`` (key = (n_pad, d_pad, device)), else ``build()``:
    only the largest rectangle is kept, and a smaller-or-equal cached one
    is evicted BEFORE the new one is built, so two never coexist on the
    device through the cache."""
    hit = cache.get(key)
    if hit is not None:
        return hit
    size = key[0] * key[1]
    if cache and size >= max(k[0] * k[1] for k in cache):
        cache.clear()
    ell = build()
    if not cache or size >= max(k[0] * k[1] for k in cache):
        cache.clear()
        cache[key] = ell
    return ell


def degree_pad_for(graph: "Graph", backend: str) -> int:
    """Degree-axis padding: 128 on the kernel path for high-degree graphs
    (whole 512-byte rows, so a warp's reads of a row stay aligned), 8
    elsewhere (low-degree graphs would waste up to 16x memory)."""
    return 128 if (backend == "pallas" and graph.max_degree >= 128) else 8


@dataclass
class Graph:
    """Host-side graph: CSR over dense int node ids.  ``node_names``
    keeps the importer's string-id mapping when the graph came from a
    file; ``simple_certified`` marks generators whose samples have no
    parallel edges."""

    n: int
    row_ptr: np.ndarray          # (n+1,) int64
    cols: np.ndarray             # (2m,) int32
    node_names: list[str] | None = None
    name: str = "graph"
    simple_certified: bool = False

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_edges(
        n: int,
        src: np.ndarray,
        dst: np.ndarray,
        *,
        both_directions_present: bool = False,
        node_names: list[str] | None = None,
        name: str = "graph",
    ) -> "Graph":
        """Build from an edge list.  Unless ``both_directions_present``,
        each undirected edge appears once and the reverse is added here.
        Self-loops are dropped; duplicate edges are kept (use
        ``dedup_edges``), as the reference does."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if not both_directions_present:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        order = np.argsort(src, kind="stable")
        src_s, dst_s = src[order], dst[order]
        counts = np.bincount(src_s, minlength=n)
        row_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return Graph(
            n=n, row_ptr=row_ptr, cols=dst_s.astype(np.int32),
            node_names=node_names, name=name,
        )

    # -- properties --------------------------------------------------------

    @cached_property
    def degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr).astype(np.int32)

    @property
    def n_edges(self) -> int:
        """Number of undirected edges (each stored twice in ``cols``)."""
        return int(self.cols.shape[0]) // 2

    @cached_property
    def max_degree(self) -> int:
        return int(self.degrees.max()) if self.n else 0

    @cached_property
    def mean_degree(self) -> float:
        return float(self.degrees.mean()) if self.n else 0.0

    @property
    def density(self) -> float:
        if self.n < 2:
            return 0.0
        return 2.0 * self.n_edges / (self.n * (self.n - 1))

    def neighbors_of(self, i: int) -> np.ndarray:
        return self.cols[self.row_ptr[i]: self.row_ptr[i + 1]]

    # -- validation and rewrites -----------------------------------------

    def validate(self) -> None:
        """Raise ``ValueError`` unless the CSR is well formed, every edge
        is mirrored and there is no self-loop."""
        if self.row_ptr.shape != (self.n + 1,):
            raise ValueError(f"row_ptr shape {self.row_ptr.shape}, n={self.n}")
        if self.row_ptr[0] != 0 or self.row_ptr[-1] != self.cols.shape[0]:
            raise ValueError("row_ptr does not span cols")
        if np.any(np.diff(self.row_ptr) < 0):
            raise ValueError("row_ptr decreases")
        if self.cols.size and (self.cols.min() < 0 or self.cols.max() >= self.n):
            raise ValueError("column id outside 0..n-1")
        u = np.repeat(np.arange(self.n, dtype=np.int64), self.degrees)
        fwd = u * self.n + self.cols
        rev = self.cols.astype(np.int64) * self.n + u
        if not np.array_equal(np.sort(fwd), np.sort(rev)):
            raise ValueError("edges not mirrored")
        if np.any(u == self.cols):
            raise ValueError("self-loop present")

    def dedup_edges(self) -> "Graph":
        """A copy with duplicate parallel edges removed."""
        u = np.repeat(np.arange(self.n, dtype=np.int64), self.degrees)
        keys = np.unique(u * self.n + self.cols)
        return Graph.from_edges(
            self.n, keys // self.n, keys % self.n, both_directions_present=True,
            node_names=self.node_names, name=self.name,
        )

    def degree_relabel(self, descending: bool = False) -> tuple["Graph", np.ndarray]:
        """Relabel vertices by degree (stable).  Returns (relabelled graph,
        perm) with ``perm[new_id] = old_id``."""
        key = -self.degrees if descending else self.degrees
        perm = np.argsort(key, kind="stable").astype(np.int64)
        inv = np.empty(self.n, np.int64)
        inv[perm] = np.arange(self.n, dtype=np.int64)
        degs = self.degrees[perm].astype(np.int64)
        row_ptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(degs, out=row_ptr[1:])
        total = int(row_ptr[-1])
        idx = (
            np.repeat(self.row_ptr[perm], degs)
            + np.arange(total, dtype=np.int64)
            - np.repeat(row_ptr[:-1], degs)
        )
        cols = inv[self.cols[idx]].astype(np.int32)
        g = Graph(n=self.n, row_ptr=row_ptr, cols=cols, node_names=None,
                  name=self.name + "_degsorted")
        return g, perm

    # -- device layout -----------------------------------------------------

    def to_ell(
        self,
        *,
        pad_nodes_to: int = 8,
        pad_degree_to: int = 8,
        min_degree_pad: int = 1,
        device="cuda",
        device_build: bool | None = None,
        build_stats: dict | None = None,
    ) -> "EllGraph":
        """Pack the CSR into the padded ELL layout on ``device``: the
        current card by default (``models/base.colorer_device``, which
        raises without one); the CPU when asked for.

        ``device_build`` picks where the rectangle is made: True scatters
        it on ``device`` from the CSR (``ops/ell_build.py``), False builds
        it on the host and copies it whole; None (default) builds on the
        card when the device is CUDA and the rectangle exceeds
        ``DEVICE_BUILD_MIN_BYTES``.

        Cached per (n_pad, d_pad, device): repeated colorers on one graph
        (ratio sweeps, repetitions) reuse the rectangle.  Only the largest
        rectangle is kept, and a smaller-or-equal cached one is evicted
        BEFORE the new one is built, so two never coexist on the device.
        """
        device = _layout_device(device)
        n_pad = _round_up(max(self.n, 1), pad_nodes_to)
        d_pad = _round_up(max(self.max_degree, min_degree_pad), pad_degree_to)
        return _cached_ell(
            self.__dict__.setdefault("_ell_cache", {}), (n_pad, d_pad, str(device)),
            lambda: self._build_ell(n_pad, d_pad, device, device_build, build_stats),
        )

    def _build_ell(self, n_pad: int, d_pad: int, device, device_build, build_stats):
        if device_build is None:
            device_build = (
                device.type == "cuda" and n_pad * d_pad * 4 > DEVICE_BUILD_MIN_BYTES
            )
        if device_build:
            from mcmc_colorer_tpu_torch.ops.ell_build import ell_neighbors_from_csr_device

            neigh = ell_neighbors_from_csr_device(
                self.row_ptr, self.cols, n_pad, d_pad, device=device,
                stats=build_stats,
            )
        else:
            host = np.full((n_pad, d_pad), n_pad, dtype=np.int32)
            degs = self.degrees
            row = np.repeat(np.arange(self.n, dtype=np.int64), degs)
            col = np.arange(self.cols.shape[0], dtype=np.int64) - np.repeat(
                self.row_ptr[:-1], degs
            )
            host[row, col] = self.cols
            neigh = torch.from_numpy(host).to(device)
        degrees = torch.zeros((n_pad,), dtype=torch.int32, device=device)
        degrees[: self.n] = torch.from_numpy(self.degrees).to(device)
        return EllGraph(
            neighbors=neigh, degrees=degrees, n_nodes=self.n,
            n_edges=self.n_edges, max_degree=self.max_degree,
        )

    def to_ell_bucketed(
        self,
        *,
        block: int = 128,
        min_lane: int = 8,
        lane_factor: int = 4,
        device="cuda",
    ) -> "BucketedEll":
        """Pack the CSR into degree-bucketed ELL rectangles on ``device``
        (the current card by default, as ``to_ell``).

        The graph must be degree-monotonic, ascending or descending (call
        ``degree_relabel`` first).  Vertices are grouped into contiguous
        classes of widths ``min_lane · lane_factor^k`` (the last one the
        max degree rounded up to ``min_lane``); each class becomes one
        rectangle padded to its width and to a ``block``-multiple height.
        Classes under ``block`` vertices are folded into the next wider
        class (ascending ids) or into the previous, wider, one (descending
        ids; a class under ``block`` also takes the one after it), as JAX
        folds them."""
        degs = self.degrees.astype(np.int64)
        if self.n <= 0:
            raise ValueError("to_ell_bucketed needs a graph with vertices")
        asc = bool(np.all(np.diff(degs) >= 0))
        if not (asc or np.all(np.diff(degs) <= 0)):
            raise ValueError(
                "to_ell_bucketed requires degree-monotonic ids: call degree_relabel() first"
            )
        maxd = max(int(degs.max()), 1)
        cap_w = _round_up(maxd, min_lane)
        widths = [min_lane]
        while widths[-1] < maxd:
            widths.append(min(widths[-1] * lane_factor, cap_w))
        segs: list[list[int]] = []  # [v0, v1, width]
        if asc:
            v0 = 0
            for w, v1 in zip(widths, np.searchsorted(degs, widths, side="right").tolist()):
                if v1 > v0:
                    segs.append([v0, v1, w])
                    v0 = v1
            folded: list[list[int]] = []
            for seg in segs:
                if folded and folded[-1][1] - folded[-1][0] < block:
                    folded[-1][1:] = seg[1:]
                else:
                    folded.append(seg)
        else:
            # widest class first; bounds[k] = first id of degree <= widths_d[k]
            widths_d = widths[::-1]
            bounds = [int(np.searchsorted(-degs, -w, side="left")) for w in widths_d]
            bounds.append(self.n)
            segs = [[bounds[k], bounds[k + 1], w] for k, w in enumerate(widths_d)
                    if bounds[k + 1] > bounds[k]]
            folded = []
            for seg in segs:
                if folded and (seg[1] - seg[0] < block or folded[-1][1] - folded[-1][0] < block):
                    folded[-1][1] = seg[1]
                else:
                    folded.append(seg)
        heights = [_round_up(b - a, block) for a, b, _ in folded]
        starts = np.concatenate([[0], np.cumsum(heights)])[:-1].tolist()
        n_pad = int(sum(heights))
        # padded-global position of every vertex id
        pos = np.empty(self.n, dtype=np.int64)
        for (a, b, _), s in zip(folded, starts):
            pos[a:b] = s + np.arange(b - a, dtype=np.int64)
        degrees = np.zeros(n_pad, dtype=np.int32)
        degrees[pos] = degs
        device = _layout_device(device)
        slices = []
        for (a, b, w), s, h_pad in zip(folded, starts, heights):
            seg_degs = degs[a:b]
            host = np.full((h_pad, w), n_pad, dtype=np.int32)
            row = np.repeat(np.arange(b - a, dtype=np.int64), seg_degs)
            base = self.row_ptr[a]
            col = np.arange(int(seg_degs.sum()), dtype=np.int64) - np.repeat(
                self.row_ptr[a:b] - base, seg_degs
            )
            host[row, col] = pos[self.cols[base: self.row_ptr[b]]]
            slices.append(EllSlice(torch.from_numpy(host).to(device), int(s), b - a))
        return BucketedEll(
            slices=tuple(slices), degrees=torch.from_numpy(degrees).to(device),
            n_nodes=self.n, n_edges=self.n_edges, max_degree=self.max_degree,
        )


class HashGraph:
    """The hash-defined G(n, p) of ``ops/hashgen.py`` (``edge(i, j) :=
    mix32(seed, min(i, j), max(i, j)) < floor(p * 2**32)``) with no host
    CSR: its degrees are counted and its flat ELL built on ``device`` by
    kernel K5 (``ops/hash_ell.py``; the plain version on the CPU), so no
    edge is sampled, sorted or uploaded by the host.

    ``degrees``, ``max_degree`` and ``n_edges`` come from K5's count pass,
    run once on the graph's device at first use and read back once;
    ``to_ell`` runs the fill pass (cached as ``Graph.to_ell`` caches);
    ``host_graph()`` enumerates the same graph on the host
    (``ops/hashgen.hash_er_graph``, O(n²)), for checking only.  It has no
    ``row_ptr``/``cols``: the colourers that need a host CSR (the
    bucketed layout, the packed backend) refuse it."""

    def __init__(self, n: int, p: float, seed: int, name: str | None = None,
                 device="cuda") -> None:
        if n < 1 or not 0.0 <= p <= 1.0:
            raise ValueError(f"HashGraph needs n >= 1 and 0 <= p <= 1, got n={n}, p={p}")
        self.n, self.p, self.seed = n, p, seed
        self.name = name or f"er_hash_{n}_{p}"
        self.device = _layout_device(device)
        self._ell_cache: dict = {}

    @cached_property
    def _counted(self) -> tuple[torch.Tensor, np.ndarray]:
        """(degrees [n] int32 on the graph's device, the same on the host)."""
        from mcmc_colorer_tpu_torch.ops.hash_ell import hash_ell_degrees

        with span("mc.hash_ell"):
            dev = hash_ell_degrees(self.n, self.p, self.seed, self.n, self.device)
            return dev, dev.cpu().numpy()

    @property
    def degrees(self) -> np.ndarray:
        return self._counted[1]

    @cached_property
    def max_degree(self) -> int:
        return int(self.degrees.max())

    @cached_property
    def n_edges(self) -> int:
        """Number of undirected edges."""
        return int(self.degrees.sum(dtype=np.int64)) // 2

    @property
    def mean_degree(self) -> float:
        return float(self.degrees.mean())

    def host_graph(self) -> Graph:
        """The same graph as a host CSR, enumerated on the host (checking
        only: O(n²) hashes)."""
        from mcmc_colorer_tpu_torch.ops.hashgen import hash_er_graph

        return hash_er_graph(self.n, self.p, self.seed, name=self.name)

    def to_ell(
        self,
        *,
        pad_nodes_to: int = 8,
        pad_degree_to: int = 8,
        min_degree_pad: int = 1,
        device=None,
    ) -> "EllGraph":
        """The flat ELL on the graph's device (``device``, if given, must
        be it): K5's fill pass over the counted degrees, rows padded to
        ``pad_nodes_to``, the max degree to ``pad_degree_to``; the sentinel
        n_pad in every padding slot, as ``Graph.to_ell`` lays it out."""
        from mcmc_colorer_tpu_torch.ops.hash_ell import d_pad_for, hash_ell_fill

        if device is not None and _layout_device(device) != self.device:
            raise ValueError(f"a HashGraph on {self.device} builds its ELL there, not on "
                             f"{_layout_device(device)}")
        n_pad = _round_up(self.n, pad_nodes_to)
        d_pad = d_pad_for(self.max_degree, pad_degree_to, min_degree_pad)

        def build() -> EllGraph:
            degrees = torch.zeros((n_pad,), dtype=torch.int32, device=self.device)
            degrees[: self.n] = self._counted[0]
            with span("mc.hash_ell"):
                neigh = hash_ell_fill(self.n, self.p, self.seed, degrees, d_pad)
            return EllGraph(neighbors=neigh, degrees=degrees, n_nodes=self.n,
                            n_edges=self.n_edges, max_degree=self.max_degree)

        return _cached_ell(self._ell_cache, (n_pad, d_pad, str(self.device)), build)


@dataclass
class EllGraph:
    """Device-resident padded adjacency.  ``neighbors[v, k]`` is the k-th
    neighbour of v, or the sentinel ``n_pad`` in padding slots; phantom
    vertices (ids >= n_nodes) have degree 0 and are outside
    ``node_mask``."""

    neighbors: torch.Tensor      # (n_pad, d_pad) int32
    degrees: torch.Tensor        # (n_pad,) int32
    n_nodes: int
    n_edges: int
    max_degree: int
    node_mask: torch.Tensor = field(init=False)  # (n_pad,) bool, real vertices

    def __post_init__(self) -> None:
        self.node_mask = (
            torch.arange(self.n_pad, device=self.neighbors.device) < self.n_nodes
        )

    @property
    def n_pad(self) -> int:
        return self.neighbors.shape[0]

    @property
    def d_pad(self) -> int:
        return self.neighbors.shape[1]

    @property
    def neighbor_mask(self) -> torch.Tensor:
        """(n_pad, d_pad) bool: True where a real neighbour is stored."""
        return self.neighbors < self.n_pad


@dataclass
class EllSlice:
    """One degree-class rectangle of a ``BucketedEll``: ``neighbors[r, k]``
    is the padded-global position of the k-th neighbour of the vertex at
    position ``start + r``, or the sentinel (the layout's ``n_pad``) in a
    padding slot.  Rows from ``n_real`` on are phantom."""

    neighbors: torch.Tensor      # (h_pad, d_b) int32, a tensor of its own
    start: int
    n_real: int

    @property
    def h_pad(self) -> int:
        return self.neighbors.shape[0]

    @property
    def d_pad(self) -> int:
        return self.neighbors.shape[1]


@dataclass
class BucketedEll:
    """Degree-bucketed device adjacency.  A flat ELL pads every row to the
    max degree, so a sweep gathers n·d_max neighbour ids; on a skewed graph
    (Barabási–Albert, most real networks) that is 10-100x the 2m real ones.
    Here each degree class is its own rectangle at its own width, so a
    sweep gathers Σ h_b·d_b ≈ 2m ids.  Vertex-indexed vectors (colours,
    taboo, uniforms) span the concatenated padded classes; each class has
    its own phantom tail, outside ``node_mask``."""

    slices: tuple[EllSlice, ...]
    degrees: torch.Tensor        # (n_pad,) int32, 0 on phantom rows
    n_nodes: int
    n_edges: int
    max_degree: int
    node_mask: torch.Tensor = field(init=False)  # (n_pad,) bool, real vertices

    def __post_init__(self) -> None:
        self.node_mask = torch.cat([
            torch.arange(s.h_pad, device=self.degrees.device) < s.n_real for s in self.slices
        ])

    @property
    def n_pad(self) -> int:
        last = self.slices[-1]
        return last.start + last.h_pad

    @property
    def gather_elements(self) -> int:
        """Neighbour ids one full sweep reads (a flat ELL reads n_pad ·
        d_pad)."""
        return sum(s.h_pad * s.d_pad for s in self.slices)

    def real_positions(self) -> np.ndarray:
        """(n_nodes,) padded-global position of each vertex id, to read
        per-vertex results out of padded vectors."""
        return np.concatenate(
            [s.start + np.arange(s.n_real, dtype=np.int64) for s in self.slices]
        )
