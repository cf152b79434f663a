"""Vertex-sharded, lock-step multi-chain MCMC over a (chains, shards) mesh.

Counterpart of ``mcmc_colorer_tpu/parallel/sharded.py``.  JAX runs one
SPMD program over the mesh inside ``shard_map``; here each
``torch.distributed`` rank (``parallel/mesh.py``) runs the same loop on
its own rows:

* rank ``(g, s)`` owns chains ``[g·cl, (g+1)·cl)`` (``cl = n_chains /
  mesh chains``) and rows ``[s·n_loc, (s+1)·n_loc)`` of each, and keeps
  only those rows of the adjacency on its device: ELL neighbour lists
  (backends ``pallas``, ``xla``) or its strip of the bit-packed A,
  [n_loc, words(n_pad)] (backend ``matmul``, spelt ``packed`` too);
* every chain's colour vector [n_pad] is whole on each rank of its chain
  group; a full sweep resamples the rank's rows and one all-gather over
  the shard group rebuilds the vector (JAX's tiled ``all_gather``).  On
  the ELL, kernel K2 (``ops/resample.resample_sweep``, one launch for the
  rank's chains, own ids from ``row0 = s·n_loc``) gathers the colours
  itself; on the strip, kernel K1 (``ops/packed_nc.packed_nc``, one launch
  for the rank's chains) gives NC = strip·onehot(colours) [cl, n_loc,
  n_col_pad] (``_strip_nc``), from which kernel K4
  (``ops/propose_nc.propose_nc``, one launch for the rank's chains)
  reads the proposal;
* per-vertex same-colour counts ``cnt`` [n_loc] are recounted from the new
  vector (``cnt_of``: a gather, or NC(star) at each row's own colour);
  conflicts are Σ cnt over the shards / 2 (each conflict edge counted by
  both owners);
* with ``active_cap`` a chain switches, sweep by sweep, to a frontier
  sweep once every shard's frontier (cnt > 0, taboo 0) fits in the cap:
  K2 on the ≤ cap frontier rows (ELL rows, or strip rows unpacked to ids)
  with their global ids as ``self_ids``, at most one ε-flip of a passive
  vertex, one all-gather of ``colour << 1 | changed`` and one all-reduce
  of the ``cnt`` delta (``active_branch``);
* Hastings (full sweeps only) gates each chain's swap on the
  shard-summed λ-weighted ratio (on the strip, q(old | star) is read from
  NC(star)); pooled annealing boosts ε when the mean conflict count over
  all chains stalls;
* the tailcut repairs the best chain: over ELL rows in rank space, K3
  (``ops/firstfit.first_fit``) giving each row's first free colour; on
  the resident hash strips (``resident_spec``), which hold no neighbour
  lists, by the strip-native independent-set rounds
  (``_tailcut_strips_round``: coins, one all-gather of the heads, one
  ``strip & head_bits`` pass, first NC-free colours, one all-gather of
  the colours, the exit NC by K1 carried into the next round), which
  JAX's cap of 16 + 2·conflicts ends; where they leave conflicts in a
  colouring whose chain converged, a serial first-free pass
  (``_finish_strips``) ends them, as on one card.

``resident_spec=(n, p, graph_seed)`` with ``graph=None`` is the hash
graph of ``ops/hashgen.py``: each rank generates its own strip on its
device (zero bytes uploaded), a ``_StatsShim`` carries the degrees for
the logs, and ``host_graph()`` re-derives the graph on the host for
checks.

The loop reads the host once a sweep: every rank's per-chain statistics
(Σ cnt, the frontier's size, the passive counts, acceptance) travel in one
``Mesh.gather_ranks``, from which every rank forms the same global
conflicts, branch decisions, trace and annealing state; these live on the
host, replicated, as the counterpart of JAX's replicated scalars, so every
rank issues the same collectives.  All chains and shards run to the
globally last convergence; converged chains freeze in place and stop
drawing.

Draws (``utils/rng.py`` sources, one a chain, the same on every rank of
its chain group):

- the initial colouring: ``next(n)`` over the real vertices;
- a full sweep: ``next(n)``, of which a rank keeps its rows (so a
  chain's full sweeps are the same on every shard count), then
  ``next(1)`` under Hastings;
- a frontier sweep: ``next(shards · cap)``, of which shard s keeps the
  s-th ``cap``, then the ε-flip's ``next(1)``, its vertex
  ``randint(1, n)`` and colour offset ``randint(1, max(nCol, 2), low=1)``;
- the tailcut draws from its own source (``TorchUniformSource(seed,
  repetition)``, the run's, as JAX's ``for_iteration(root, 999_999)``):
  in rank space one ``randint(n, nCol)`` a round, on the strips one
  ``next(n_pad)`` of coins a round; a rank keeps its rows of either.

JAX draws a shard's uniforms from ``fold_in(key, shard)``; tests replay
those by concatenating the shards' draws in this order.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from mcmc_colorer_tpu_torch.config import MCMCParams, default_n_colors
from mcmc_colorer_tpu_torch.graph.container import DEVICE_BUILD_MIN_BYTES, Graph, degree_pad_for
from mcmc_colorer_tpu_torch.models.base import Coloring
from mcmc_colorer_tpu_torch.models.mcmc import (
    _at_color,
    _bands,
    _p_eff,
    _reverse_logq_nc,
    _reverse_q,
    choose_block_size,
)
from mcmc_colorer_tpu_torch.models.mcmc_resident import (
    _any_neighbor_in,
    _first_free,
    _free_color_of_row,
    _pack_mask,
    _round_up,
    _StatsShim,
)
from mcmc_colorer_tpu_torch.ops.dense_adj import (
    STRIP_MAX_BYTES,
    adjacency_nnz,
    build_packed_rows,
    n_col_pad_of,
    packed_adj_words,
    packed_rows_to_ids,
    refuse_multigraph,
)
from mcmc_colorer_tpu_torch.ops.hashgen import (
    er_degrees_on_device,
    er_packed_on_device_cached,
    er_packed_strips_on_device,
    hash_er_graph,
)
from mcmc_colorer_tpu_torch.ops.neighbor import (
    color_histogram,
    frontier_ids,
    neighbor_colors,
    occupancy_matrix,
    scatter_drop,
)
from mcmc_colorer_tpu_torch.ops.packed_nc import packed_nc
from mcmc_colorer_tpu_torch.ops.propose_nc import propose_nc
from mcmc_colorer_tpu_torch.parallel.mesh import Mesh
from mcmc_colorer_tpu_torch.utils.rng import TorchUniformSource

# JAX's sweep-block target (models/mcmc.py:_BLOCK_BYTES_TARGET): here it
# only fixes the shard geometry (n_loc, n_pad), which checkpoints and
# JAX's per-shard draws share with the JAX package
_BLOCK_BYTES_TARGET = 32 * 1024 * 1024


def shard_block_size(n: int, n_colors: int) -> int:
    """JAX's ``choose_block_size``: a power of two, at least 128, whose
    [block, nCol] float32 temporary is about 32 MB; n itself rounded up to
    a power of two when smaller."""
    b = _BLOCK_BYTES_TARGET // max(4 * n_colors, 1)
    b = max(128, min(1 << 16, b))
    b = 1 << int(math.floor(math.log2(b)))
    if n <= b:
        return max(128, 1 << int(math.ceil(math.log2(max(n, 8)))))
    return b


def _check_strip_bytes(n_loc: int, n_pad: int, shards: int, hint: str = "",
                       bound: str = "") -> None:
    """Refuse a geometry whose [n_loc, words(n_pad)] strip exceeds
    ``STRIP_MAX_BYTES`` (``ops/dense_adj.py``: the card's resident budget
    behind ``PACKED_ADJ_MAX_N``; JAX's 12 GB is a TPU v5e's figure)."""
    strip_bytes = n_loc * packed_adj_words(n_pad) * 4
    if strip_bytes > STRIP_MAX_BYTES:
        raise ValueError(
            f"packed adjacency strip needs {strip_bytes / 1e9:.1f} GB per shard at "
            f"n_pad={n_pad} over {shards} shards{bound} (at most "
            f"{STRIP_MAX_BYTES / 1e9:.1f} GB); add shards{hint}"
        )


def _resident_palette(spec: tuple, params: MCMCParams, mesh: Mesh, n_chains: int | None,
                      num_col_ratio: float) -> MCMCParams:
    """JAX :159-215, before any device work: refuse a hash graph whose
    strip cannot fit a shard (the strip's rows from the block the palette
    fixes, or, before the palette is known, from the bound n_loc < per-shard
    rows + block), then resolve ``n_colors <= 0`` to ``max_degree /
    num_col_ratio`` from the banded degree pass over the mesh."""
    n, p, seed = spec
    ms = mesh.shards
    per_shard = ((-(-n // ms) + 127) // 128) * 128
    if params.n_colors > 0:
        cl = max(1, (n_chains or mesh.chains) // mesh.chains)
        block = min(shard_block_size(n, params.n_colors * cl), per_shard)
        n_loc = -(-per_shard // block) * block
    else:
        n_loc = per_shard + min(per_shard, 1 << 16)
    _check_strip_bytes(n_loc, ms * n_loc, ms, ", or pass n_colors to tighten the bound",
                       f" (n={n}, n_loc bound {n_loc})")
    if params.n_colors <= 0:
        deg = er_degrees_on_device(n, p, seed, mesh=mesh)
        params = params.replace(n_colors=default_n_colors(int(deg.max()), num_col_ratio))
    return params


# the hash strips have no host graph to hang a cache on: one slot, keyed
# by (spec, n_pad, geometry), cleared before a new build, so sweeping many
# graphs in one process never holds more than one strip
_RESIDENT_STRIP_CACHE: dict = {}


def _resident_strips(spec: tuple, n_pad: int, mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's strip of the hash graph and its rows' degrees, built
    together (JAX ``_resident_strips``, which returns the strip alone).
    On one shard at the resident colorers' n_pad (n rounded up to 2048)
    the strip is their whole A: the same cache slot
    (``er_packed_on_device_cached``) serves both, one copy on the card."""
    n, p, seed = spec
    if mesh.shards == 1 and n_pad == _round_up(n, 2048):
        return er_packed_on_device_cached(n, p, seed, n_pad, device=mesh.device)
    key = (n, float(p), int(seed), n_pad, mesh.shards, mesh.shard_index, str(mesh.device))
    if key not in _RESIDENT_STRIP_CACHE:
        _RESIDENT_STRIP_CACHE.clear()
        _RESIDENT_STRIP_CACHE[key] = er_packed_strips_on_device(n, p, seed, n_pad, mesh)
    return _RESIDENT_STRIP_CACHE[key]


def _strip_nc(strip: torch.Tensor, colors: torch.Tensor, full_real: torch.Tensor,
              n_colors: int) -> torch.Tensor:
    """[..., n_loc, n_col_pad] neighbour-colour counts of a strip's rows for
    whole colour vectors ``colors`` ([n_pad] or [C, n_pad]), padding
    vertices (outside ``full_real``) recoloured -1 so they count nowhere:
    kernel K1 (``ops/packed_nc.packed_nc``, one launch for all chains) on
    CUDA tensors, its plain version on CPU tensors (JAX ``_strip_nc``,
    sharded.py:784-803).  A row's own-colour count NC[i, colour_i] is
    ``_at_color`` (JAX ``_nc_own_count``)."""
    masked = torch.where(full_real, colors, -1)
    return packed_nc(strip, masked, n_col_pad_of(n_colors))


@dataclass(frozen=True)
class AnnealConfig:
    """Pooled ε-annealing: if the pooled mean conflict count improves by
    less than ``tol`` for ``window`` consecutive sweeps, multiply ε by
    ``boost`` (capped so (nCol−1)·ε stays well below 1)."""

    enabled: bool = False
    tol: float = 0.01
    window: int = 10
    boost: float = 4.0


@dataclass
class ShardedState:
    """One rank's ensemble state: JAX's 11 fields, with the keys as the
    chains' sources.  Device tensors hold this rank's chains (``cl``) and
    rows (``n_loc``); the host fields hold every chain, the same on every
    rank (``stats``: the next sweep's branch inputs, derived)."""

    colors: torch.Tensor      # [cl, n_pad] int32, whole vectors
    taboo: torch.Tensor       # [cl, n_loc] int32
    cnt: torch.Tensor         # [cl, n_loc] int32 same-colour neighbours
    sources: list             # cl chain sources (utils/rng.py)
    rip: int
    conflicts: np.ndarray     # [C] int64
    trace: np.ndarray         # [C, max_iterations + 1] int32, -1 unwritten
    eps_scale: np.float32
    prev_pooled: np.float32
    stall: int
    accstats: np.ndarray      # [C, 2] int64 (accepted, attempted)
    frontier: np.ndarray      # [C] int64 frontier sweeps
    stats: np.ndarray | None = field(default=None, repr=False)  # [C, 3]


class ShardedMCMCColorer:
    """MCMC ensemble over a ``(chains, shards)`` mesh (``parallel/mesh.py``).

    ``backend``: ``pallas`` (kernel K2 on the card; ``auto`` is it over a
    host graph), ``xla`` (K2's plain version) or ``matmul`` (``packed``:
    each rank's strip of the bit-packed A, built on its device from its
    ELL rows, and NC by kernel K1).  ``resident_spec=(n, p, graph_seed)``
    with ``graph=None``: the hash graph, each rank's strip generated on
    its device (``matmul`` only; ``params.n_colors <= 0`` resolves to
    ``max_degree / num_col_ratio`` through a banded degree pass first).
    ``active_cap``: per-shard frontier capacity (rounded up to a multiple
    of 128); None runs full sweeps only."""

    def __init__(
        self,
        graph: Graph | None,
        params: MCMCParams,
        mesh: Mesh,
        n_chains: int | None = None,
        anneal: AnnealConfig | None = None,
        backend: str = "auto",
        active_cap: int | None = None,
        resident_spec: tuple | None = None,
        num_col_ratio: float = 1.0,
    ) -> None:
        if params.hastings and active_cap is not None:
            # the frontier sweep never forms the passive set's proposal
            # probability, so the Hastings ratio is undefined there
            raise NotImplementedError("hastings=True requires full sweeps (active_cap=None)")
        if backend == "packed":  # the CLI's spelling of the strip layout (JAX cli.py:358)
            backend = "matmul"
        self.resident_spec = resident_spec
        if resident_spec is not None:
            if graph is not None:
                raise ValueError("pass graph=None with resident_spec")
            if backend == "auto":
                backend = "matmul"
            if backend != "matmul":
                raise ValueError("resident_spec implies the adjacency-strip backend "
                                 f"(matmul); got {backend!r}")
            params = _resident_palette(resident_spec, params, mesh, n_chains, num_col_ratio)
        if backend == "auto":
            backend = "pallas"
        if backend not in ("pallas", "xla", "matmul"):
            raise ValueError(f"unknown sharded backend {backend!r}")
        self.backend, self.graph, self.params, self.mesh = backend, graph, params, mesh
        mc, ms = mesh.chains, mesh.shards
        self.n_chains = n_chains or mc
        if self.n_chains % mc:
            raise ValueError("n_chains must be a multiple of the chains axis")
        self.cl = cl = self.n_chains // mc
        self.anneal = anneal or AnnealConfig()
        self.device = mesh.device
        g_n = graph.n if resident_spec is None else resident_spec[0]
        # size the per-shard slice so every shard owns real vertices
        per_shard = -(-g_n // ms)
        per_shard = ((per_shard + 127) // 128) * 128
        self.block = min(shard_block_size(g_n, params.n_colors * cl), per_shard)
        self.n_loc = n_loc = ((per_shard + self.block - 1) // self.block) * self.block
        self.n_pad = ms * n_loc
        self.offset = mesh.shard_index * n_loc
        self.n_real = min(max(g_n - self.offset, 0), n_loc)  # this rank's real rows
        # the strip proposal's row blocks: the port's sweep blocks
        # (models/mcmc.py), sized for the card's launch overhead
        self._prop_block = choose_block_size(g_n, params.n_colors)
        t0 = time.perf_counter()
        self.neighbors = self.strip = self.d_pad = None
        if resident_spec is not None:
            _check_strip_bytes(n_loc, self.n_pad, ms)
            self.strip, strip_degrees = _resident_strips(resident_spec, self.n_pad, mesh)
            self.graph = self._stats_shim(strip_degrees)
            # the frontier's rows unpacked from the strip: every real row
            # fits this many ids (JAX rows_from_strip)
            self.d_row = _round_up(max(self.graph.max_degree, 1), 8)
        else:
            pad_deg = degree_pad_for(graph, backend)
            self.d_pad = ((max(graph.max_degree, 1) + pad_deg - 1) // pad_deg) * pad_deg
            self.neighbors = self._shard_neighbors()
            if backend == "matmul":
                _check_strip_bytes(n_loc, self.n_pad, ms, " or use backend='pallas'")
                self.strip = self._build_packed_strips()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_seconds = time.perf_counter() - t0
        if active_cap is not None:
            active_cap = min(n_loc, ((max(active_cap, 1) + 127) // 128) * 128)
        self.active_cap = active_cap
        dev = self.device
        self._gids = self.offset + torch.arange(n_loc, dtype=torch.int32, device=dev)
        self._real_loc = self._gids < g_n
        self._full_real = torch.arange(self.n_pad, device=dev) < g_n

    def _stats_shim(self, strip_degrees: torch.Tensor) -> _StatsShim:
        """The hash graph's stats for the logs (JAX :267-289): this rank's
        rows' degrees, written with its strip, and the other ranks' from
        one all-gather over the shard group."""
        n, p, _ = self.resident_spec
        degrees = self.mesh.all_gather_shards(strip_degrees)
        host = degrees[:n].cpu().numpy()
        max_degree = int(host.max()) if n else 0
        return _StatsShim(n, int(host.astype(np.int64).sum() // 2), host, max_degree,
                          f"er_hash_{n}_{p}")

    def host_graph(self) -> Graph:
        """Resident specs only: host CSR of the same hash graph (threaded
        C++ enumeration), for validation (``--check``)."""
        if self.resident_spec is None:
            raise ValueError("host_graph() is for resident_spec colorers")
        n, p, seed = self.resident_spec
        return hash_er_graph(n, p, seed, name=self.graph.name)

    def _build_packed_strips(self) -> torch.Tensor:
        """This rank's [n_loc, words] strip of the host graph's packed A
        (JAX ``_build_packed_strips``), built on its device from its ELL
        rows (padding id ``n_pad``) and cached on the graph like
        ``get_adjacency``, by (n_pad, shards, shard, device).  Unless the
        generator certifies the graph simple, the strip's set bits must
        be its rows' CSR entries: a duplicate edge collapses to one bit;
        the shortfall is summed over the shard group, so every rank
        refuses alike instead of leaving the others in a collective."""
        g, mesh = self.graph, self.mesh
        cache = g.__dict__.setdefault("_adj_cache", {})
        key = (self.n_pad, "strips", mesh.shards, mesh.shard_index, str(self.device))
        if key not in cache:
            strip = build_packed_rows(self.neighbors, self.n_pad)
            if not g.simple_certified:
                r0, r1 = self.offset, self.offset + self.n_real
                entries = int(g.row_ptr[r1] - g.row_ptr[r0]) if r1 > r0 else 0
                extra = torch.tensor([entries - adjacency_nnz(strip)], device=self.device)
                refuse_multigraph(int(mesh.all_reduce_shards(extra)[0]))
            cache[key] = strip
        return cache[key]

    def _shard_neighbors(self) -> torch.Tensor:
        """This rank's [n_loc, d_pad] ELL rows, padding ids ``n_pad``: the
        graph's cached ELL on a one-shard mesh, else the rank's slice of
        the CSR laid out on its own (on the card for large slices)."""
        g, dev, n_loc = self.graph, self.device, self.n_loc
        if self.mesh.shards == 1:
            return g.to_ell(pad_nodes_to=n_loc, pad_degree_to=self.d_pad, device=dev).neighbors
        r0, r1 = self.offset, self.offset + self.n_real
        rp = g.row_ptr
        sub_rp = rp[r0:r1 + 1] - rp[r0] if r1 > r0 else np.zeros(1, np.int64)
        cols = g.cols[rp[r0]:rp[r1]] if r1 > r0 else g.cols[:0]
        if dev.type == "cuda" and n_loc * self.d_pad * 4 > DEVICE_BUILD_MIN_BYTES:
            from mcmc_colorer_tpu_torch.ops.ell_build import ell_neighbors_from_csr_device

            return ell_neighbors_from_csr_device(sub_rp, cols, n_loc, self.d_pad, device=dev,
                                                 sentinel=self.n_pad)
        host = np.full((n_loc, self.d_pad), self.n_pad, dtype=np.int32)
        degs = np.diff(sub_rp)
        row = np.repeat(np.arange(r1 - r0, dtype=np.int64), degs)
        slot = np.arange(cols.shape[0], dtype=np.int64) - np.repeat(sub_rp[:-1], degs)
        host[row, slot] = cols
        return torch.from_numpy(host).to(dev)

    # ---- ensemble state plumbing -----------------------------------------

    def _local_chains(self) -> range:
        g = self.mesh.chain_index
        return range(g * self.cl, (g + 1) * self.cl)

    def _local_sources(self, seed, repetition, sources):
        if sources is not None:
            return [sources[c] for c in self._local_chains()]
        return [TorchUniformSource(seed, repetition, self.device, chain=c)
                for c in self._local_chains()]

    def init_state(self, seed: int, repetition: int = 0, sources=None) -> ShardedState:
        """Fresh ensemble state (JAX's ``_sharded_init``): each chain's
        uniform initial colouring from ``next(n)`` of its source (chain c:
        ``TorchUniformSource(seed, repetition, chain=c)``, or
        ``sources[c]``), its counts and conflicts, trace row 0."""
        p, n, dev = self.params, self.graph.n, self.device
        srcs = self._local_sources(seed, repetition, sources)
        colors = torch.full((self.cl, self.n_pad), p.n_colors, dtype=torch.int32, device=dev)
        for k, src in enumerate(srcs):
            u = src.next(n).to(dev)
            colors[k, :n] = (u * p.n_colors).to(torch.int32).clamp(max=p.n_colors - 1)
        c = self.n_chains
        st = ShardedState(
            colors=colors, taboo=torch.zeros((self.cl, self.n_loc), dtype=torch.int32, device=dev),
            cnt=self._cnt_of(colors), sources=srcs, rip=0,
            conflicts=np.zeros(c, np.int64),
            trace=np.full((c, p.max_iterations + 1), -1, dtype=np.int32),
            eps_scale=np.float32(1.0), prev_pooled=np.float32(1e30), stall=0,
            accstats=np.zeros((c, 2), np.int64), frontier=np.zeros(c, np.int64),
        )
        st.conflicts = self._refresh(st)[0]
        st.trace[:, 0] = st.conflicts
        return st

    def state_from_numpy(self, fields: dict, sources) -> ShardedState:
        """This rank's state from the global fields of a checkpoint (JAX's
        or the port's, by JAX's names: colors, taboo, cnt, rip, conflicts,
        trace, eps_scale, prev_pooled, stall, accstats; the keys left
        out), on this colorer's mesh, whatever the writer's: the vertex
        axis is re-padded (phantom slots hold colour nCol, taboo and cnt
        0, so trimming or extending them is exact).  ``sources``: this
        rank's chains' sources, positioned where the checkpoint's keys
        were."""
        dev, n_pad = self.device, self.n_pad
        chains = list(self._local_chains())

        def repad(name):
            a = np.asarray(fields[name])
            if a.shape[1] != n_pad:
                fill = self.params.n_colors if name == "colors" else 0
                out = np.full((a.shape[0], n_pad), fill, a.dtype)
                keep = min(n_pad, a.shape[1])
                out[:, :keep] = a[:, :keep]
                a = out
            return a[chains]

        def local(name):
            a = repad(name)[:, self.offset:self.offset + self.n_loc]
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

        colors = torch.from_numpy(np.ascontiguousarray(repad("colors"), np.int32)).to(dev)
        c = self.n_chains
        st = ShardedState(
            colors=colors, taboo=local("taboo"), cnt=local("cnt"), sources=list(sources),
            rip=int(fields["rip"]), conflicts=np.array(fields["conflicts"], np.int64).reshape(c),
            trace=np.array(fields["trace"], np.int32),
            eps_scale=np.float32(fields["eps_scale"]),
            prev_pooled=np.float32(fields["prev_pooled"]), stall=int(fields["stall"]),
            accstats=(np.array(fields["accstats"], np.int64) if "accstats" in fields
                      else np.zeros((c, 2), np.int64)),
            frontier=(np.array(fields["frontier"], np.int64) if "frontier" in fields
                      else np.zeros(c, np.int64)),
        )
        self._refresh(st)
        return st

    def save_checkpoint(self, state: ShardedState, path: str) -> None:
        """Checkpoint the whole ensemble to an ``.npz``: JAX's fields, the
        chains' generator states (``rng``, [C, bytes] uint8) in place of
        the keys, and the frontier counts.  Every rank contributes its
        chains and rows (one collective); rank 0 writes (tmp + atomic
        rename, so a kill mid-write keeps the previous checkpoint)."""
        mine = (state.colors.cpu().numpy(), state.taboo.cpu().numpy(),
                state.cnt.cpu().numpy(),
                [np.asarray(s.get_state().cpu().numpy(), np.uint8) for s in state.sources])
        parts = self.mesh.gather_objects(mine)
        if self.mesh.rank == 0:
            mc, ms = self.mesh.chains, self.mesh.shards
            by = [[parts[g * ms + s] for s in range(ms)] for g in range(mc)]
            d = {
                "colors": np.concatenate([row[0][0] for row in by]),
                "taboo": np.concatenate([np.concatenate([p[1] for p in row], 1) for row in by]),
                "cnt": np.concatenate([np.concatenate([p[2] for p in row], 1) for row in by]),
                "rng": np.stack([r for row in by for r in row[0][3]]),
                "rip": state.rip, "conflicts": state.conflicts, "trace": state.trace,
                "eps_scale": state.eps_scale, "prev_pooled": state.prev_pooled,
                "stall": state.stall, "accstats": state.accstats, "frontier": state.frontier,
                "n_nodes": self.graph.n, "n_colors": self.params.n_colors,
                "n_chains": self.n_chains,
            }
            tmp = path + ".tmp.npz"
            np.savez(tmp, **d)
            os.replace(tmp, path if path.endswith(".npz") else path + ".npz")
        self.mesh.barrier()

    def load_checkpoint(self, path: str) -> ShardedState:
        """Rebuild this rank's state from an ``.npz`` of
        ``save_checkpoint``; the mesh geometry may differ from the
        writer's (state re-shards)."""
        if not path.endswith(".npz"):
            path = path + ".npz"
        d = np.load(path)
        if int(d["n_nodes"]) != self.graph.n:
            raise ValueError("checkpoint: graph mismatch")
        if int(d["n_colors"]) != self.params.n_colors:
            raise ValueError("checkpoint: palette mismatch")
        if int(d["n_chains"]) != self.n_chains:
            raise ValueError("checkpoint: chain-count mismatch")
        sources = []
        for c in self._local_chains():
            src = TorchUniformSource(0, 0, self.device, chain=c)
            src.set_state(torch.from_numpy(np.array(d["rng"][c], np.uint8)))
            sources.append(src)
        return self.state_from_numpy({k: d[k] for k in d.files}, sources)

    # ---- run --------------------------------------------------------------

    def _agree(self, budget: int) -> int:
        """Rank 0's segment budget on every rank: segments end where
        checkpoints (a collective) are written, so all ranks must cut them
        alike, while each times its own segments."""
        if not self.mesh.distributed:
            return budget
        t = torch.tensor([budget], dtype=torch.int64, device=self.device)
        return int(self.mesh.broadcast(t, 0)[0])

    def run(self, seed: int, repetition: int = 0, segment: int | None = None,
            checkpoint_path: str | None = None, resume_from: str | None = None,
            sources=None, tailcut_source=None, state: ShardedState | None = None):
        """Returns (best Coloring [tailcut applied if configured],
        per-chain summaries), the same on every rank.

        ``segment``/``checkpoint_path``/``resume_from`` drive the loop in
        host-visible segments with ensemble checkpoints (fixed segments
        of ``segment`` sweeps, else ``utils/segmented.drive_segments``).
        ``sources`` (all chains') replace the chains' sources,
        ``tailcut_source`` the tailcut's, and ``state`` the initial state
        (``state_from_numpy``)."""
        from mcmc_colorer_tpu_torch.utils.segmented import drive_segments

        p, n = self.params, self.graph.n
        _sync(self.device)
        t0 = time.perf_counter()
        if state is None:
            state = (self.load_checkpoint(resume_from) if resume_from
                     else self.init_state(seed, repetition, sources))
        z = p.tailcut_threshold(n)
        maxr = p.max_iterations

        def done(st):
            return st.rip >= maxr or not (st.conflicts > z).any()

        if segment is not None:
            while not done(state):
                state = self._run_sharded_segment(state, min(state.rip + segment, maxr))
                if checkpoint_path:
                    self.save_checkpoint(state, checkpoint_path)
        else:
            on_seg = ((lambda st, *_a: self.save_checkpoint(st, checkpoint_path))
                      if checkpoint_path else None)
            state = drive_segments(
                lambda st, b: self._run_sharded_segment(st, min(st.rip + self._agree(b), maxr)),
                state, lambda st: (st.rip, done(st)), on_segment=on_seg)
        _sync(self.device)
        chain_s = time.perf_counter() - t0
        dur = chain_s * 1e3
        rip, conflicts = state.rip, state.conflicts.copy()
        local = state.colors[:, :n].cpu().numpy()
        stds_local = [float(np.bincount(c, minlength=p.n_colors).std()) for c in local]
        ms = self.mesh.shards
        stds = np.array([x for r, part in enumerate(self.mesh.gather_objects(stds_local))
                         if r % ms == 0 for x in part])
        best = int(np.lexsort((stds, conflicts))[0])
        g_best, k_best = divmod(best, self.cl)
        row = state.colors[k_best] if g_best == self.mesh.chain_index else state.colors[0]
        best_full = self.mesh.broadcast(row, g_best * ms)
        tc_rounds = 0
        t1 = time.perf_counter()
        if p.tailcut and conflicts[best] > 0:
            src = tailcut_source or TorchUniformSource(seed, repetition, self.device)
            if self.neighbors is None:  # the resident strips hold no neighbour lists
                best_full, conflicts[best], tc_rounds = self._tailcut_strips(
                    best_full, int(conflicts[best]), src)
            else:
                best_full, conflicts[best], tc_rounds = self._tailcut(best_full, src)
        best_colors = best_full[:n].cpu().numpy()
        tailcut_s = time.perf_counter() - t1
        acc = state.accstats
        summaries = [
            {"chain": i, "conflicts": int(conflicts[i]), "class_std": float(stds[i]),
             "accepted_sweeps": int(acc[i, 0]), "attempted_sweeps": int(acc[i, 1])}
            for i in range(self.n_chains)
        ]
        coloring = Coloring(
            colors=best_colors,
            n_colors=p.n_colors,
            iterations=rip,
            converged=int(conflicts[best]) <= max(z, 0),
            duration_ms=dur,
            conflict_trace=state.trace[best, : rip + 1].astype(np.int64),
            extra={
                "final_conflicts": int(conflicts[best]),
                "max_iter_reached": rip >= p.max_iterations,
                "best_chain": best,
                "n_chains": self.n_chains,
                "tailcut_rounds": int(tc_rounds),
                "final_eps_scale": float(state.eps_scale),
                "accepted_sweeps": int(acc[best, 0]),
                "attempted_sweeps": int(acc[best, 1]),
                "frontier_sweeps": int(state.frontier[best]),
                "chain_seconds": chain_s,
                "tailcut_seconds": tailcut_s,
                "setup_seconds": self.setup_seconds,
            },
        )
        return coloring, summaries

    # ---- the segment (JAX's _run_sharded_segment) --------------------------

    def _cnt_of(self, colors: torch.Tensor) -> torch.Tensor:
        """[k, n_loc] same-colour neighbours of this rank's rows for the
        chains' whole vectors ``colors`` [k, n_pad] (JAX's ``cnt_of``).  On
        the strip: NC (one K1 launch) at each row's own colour (JAX's
        ``cnt_of_nc``).  On the ELL: one gather a row band, of int16
        colours where the palette fits them; the compare's bytes summed as
        uint8 over slot groups of at most 128 (no count exceeds the group)
        before the int32 sum, so no widened copy of the band is made.
        Phantom rows 0."""
        if self.strip is not None:
            own = colors[:, self.offset:self.offset + self.n_loc]
            return _at_color(self._nc(colors), own)
        k = colors.shape[0]
        dev = colors.device
        out = torch.zeros((k, self.n_loc), dtype=torch.int32, device=dev)
        off, d = self.offset, self.d_pad
        narrow = torch.int16 if self.params.n_colors < 2**15 - 1 else torch.int32
        cols = colors.to(narrow)
        ext = torch.cat([cols, torch.full((k, 1), -1, dtype=narrow, device=dev)], 1)
        group = math.gcd(d, 128)
        for s, e in _bands(self.n_real, d * k):
            nb = self.neighbors[s:e]
            nc = ext.index_select(1, nb.reshape(-1)).view(k, e - s, d)
            same = (nc == cols[:, off + s:off + e, None]).view(torch.uint8)
            out[:, s:e] = same.view(k, e - s, d // group, group).sum(
                3, dtype=torch.uint8).sum(2, dtype=torch.int32)
        return out

    def _refresh(self, st: ShardedState, accepted: torch.Tensor | None = None):
        """The sweep's one host read: every rank's per-chain Σ cnt, frontier
        size, passive counts and acceptance, gathered over the mesh.  Sets
        ``st.stats`` (frontier size, max over the shards; passive
        vertices; taboo-free passive vertices: the next sweep's branch
        inputs) and returns (the conflicts of ``st``'s colourings [C], the
        acceptance flags [C])."""
        cnt, taboo, real = st.cnt, st.taboo, self._real_loc
        zero = torch.zeros(cnt.shape[0], dtype=torch.int64, device=cnt.device)
        cols = [cnt.sum(1, dtype=torch.int64)]
        if self.active_cap is not None:
            free = (taboo == 0) & real
            cols += [((cnt > 0) & free).sum(1), ((cnt == 0) & real).sum(1),
                     ((cnt == 0) & free).sum(1)]
        else:
            cols += [zero, zero, zero]
        cols.append(zero + 1 if accepted is None else accepted.to(torch.int64))
        got = self.mesh.gather_ranks(torch.stack(cols, 1))  # [mc, ms, cl, 5]
        c = self.n_chains
        st.stats = np.stack([got[..., 1].max(1).reshape(c), got[..., 2].sum(1).reshape(c),
                             got[..., 3].sum(1).reshape(c)], 1)
        # each conflict edge is counted by the owners of both endpoints
        return got[..., 0].sum(1).reshape(c) // 2, got[:, 0, :, 4].reshape(c).astype(bool)

    def _run_sharded_segment(self, st: ShardedState, rip_limit: int) -> ShardedState:
        """Advance the ensemble until every chain converged or ``rip``
        reaches ``rip_limit`` (or the iteration cap)."""
        z = self.params.tailcut_threshold(self.graph.n)
        if st.stats is None:
            self._refresh(st)
        while ((st.conflicts > z).any() and st.rip < rip_limit
               and st.rip < self.params.max_iterations):
            st = self._sweep(st)
        return st

    def _eps_eff(self, st: ShardedState) -> np.float32:
        eps_cap = np.float32(0.4 / max(self.params.n_colors - 1, 1))
        return np.minimum(np.float32(self.params.epsilon) * st.eps_scale, eps_cap)

    def _sweep(self, st: ShardedState) -> ShardedState:
        """One lock-step sweep of every chain (JAX's ``loop_body``)."""
        p = self.params
        z = p.tailcut_threshold(self.graph.n)
        cap = self.active_cap
        active = st.conflicts > z                       # [C], every chain
        eps_eff = self._eps_eff(st)
        p_per = np.minimum(np.float32(p.n_colors - 1) * eps_eff, np.float32(0.999999))
        if cap is None:
            use_active = np.zeros(self.n_chains, bool)
        else:
            # the frontier approximates the passive dynamics with at most
            # one ε-flip a sweep: valid only while n_passive·(nCol−1)·ε is
            # small, so a boosted ε falls back to full sweeps
            use_active = ((st.stats[:, 0] <= cap)
                          & (st.stats[:, 1].astype(np.float32) * p_per <= np.float32(1.0)))
        eps_t = torch.full((), float(eps_eff), dtype=torch.float32, device=self.device)
        chains = list(self._local_chains())
        full = [k for k, c in enumerate(chains) if active[c] and not use_active[c]]
        front = [k for k, c in enumerate(chains) if active[c] and use_active[c]]
        colors, taboo, cnt = list(st.colors), list(st.taboo), list(st.cnt)
        accepted = torch.ones(self.cl, dtype=torch.bool, device=self.device)
        if full:
            star, tb, ct, acc = self._full_branch(st, full, eps_t)
            for j, k in enumerate(full):
                colors[k], taboo[k], cnt[k], accepted[k] = star[j], tb[j], ct[j], acc[j]
        for k in front:
            colors[k], taboo[k], cnt[k] = self._active_branch(st, k, eps_t, eps_eff, p_per)
        st = ShardedState(torch.stack(colors), torch.stack(taboo), torch.stack(cnt), st.sources,
                          st.rip, st.conflicts, st.trace, st.eps_scale, st.prev_pooled,
                          st.stall, st.accstats.copy(), st.frontier.copy())
        conflicts_star, acc = self._refresh(st, accepted)
        # converged chains stay frozen: neither attempt nor accept
        st.accstats[:, 0] += acc & active
        st.accstats[:, 1] += active
        st.frontier += active & use_active
        st.conflicts = np.where(active, conflicts_star, st.conflicts)
        st.rip += 1
        st.trace[:, st.rip] = st.conflicts
        if self.anneal.enabled:
            a = self.anneal
            pooled = np.float32(st.conflicts.sum()) / np.float32(self.n_chains)
            rel = (st.prev_pooled - pooled) / np.maximum(st.prev_pooled, np.float32(1.0))
            st.stall = st.stall + 1 if rel < np.float32(a.tol) else 0
            if st.stall >= a.window:
                st.eps_scale = np.float32(st.eps_scale * np.float32(a.boost))
                st.stall = 0
            st.prev_pooled = pooled
        return st

    def _sweep_fn(self):
        """K2 (``pallas``, and the frontier rows of ``matmul``), or its
        plain version (``xla``)."""
        from mcmc_colorer_tpu_torch.ops.resample import resample_sweep, resample_sweep_plain

        return resample_sweep_plain if self.backend == "xla" else resample_sweep

    def _nc(self, colors: torch.Tensor) -> torch.Tensor:
        """NC of this rank's strip rows for whole vectors ``colors``."""
        return _strip_nc(self.strip, colors, self._full_real, self.params.n_colors)

    def _full_branch(self, st: ShardedState, ks: list, eps_t: torch.Tensor):
        """Full synchronous sweep of the local chains ``ks`` (JAX's
        ``chain_sweep`` + ``full_branch``): K2 over the rank's real rows
        for all of them in one launch (or, on the strip, K1's NC for all
        of them and the proposal read from it), the shard all-gather, the
        cnt recount (on the strip from NC(star), one more K1 launch) and,
        under Hastings, the shard-summed acceptance test.  Returns
        (colours [k, n_pad], taboo, cnt [k, n_loc], accepted [k])."""
        p, n, off, nr, n_loc = self.params, self.graph.n, self.offset, self.n_real, self.n_loc
        dev = self.device
        idx = torch.tensor(ks, dtype=torch.int64, device=dev)
        cf = st.colors.index_select(0, idx)
        tb = st.taboo.index_select(0, idx)
        srcs = [st.sources[k] for k in ks]
        unif = torch.stack([s.next(n).to(dev) for s in srcs])[:, off:off + nr].contiguous()
        u_acc = torch.stack([s.next(1).to(dev) for s in srcs])[:, 0] if p.hastings else None
        p_eff = _p_eff(cf, p, n, self._full_real)
        if self.strip is not None:
            # phantom rows draw nothing: they keep their colour (nCol)
            unif_loc = torch.zeros(tb.shape, dtype=torch.float32, device=dev)
            unif_loc[:, :nr] = unif
            nc = self._nc(cf)
            star_loc, new_tb, logq_star, _ = propose_nc(
                nc, cf[:, off:off + n_loc].contiguous(), tb, unif_loc, self._real_loc, p_eff,
                eps_t, p, self._prop_block)
            del nc  # one NC at a time: each is [k, n_loc, n_col_pad] int32
        else:
            cur = cf[:, off:off + nr].contiguous()
            star_r, qstar, new_tb_r, _ = self._sweep_fn()(
                self.neighbors[:nr], cf[:, :n].contiguous(), cur, tb[:, :nr].contiguous(), off,
                unif, p_eff, eps_t, p)
            star_loc = cf[:, off:off + n_loc].clone()   # phantom rows keep nCol
            star_loc[:, :nr] = star_r
            new_tb = torch.zeros_like(tb)               # and taboo 0
            new_tb[:, :nr] = new_tb_r
            logq_star = torch.log(qstar.clamp(min=1e-30)).sum(1) if p.hastings else None
        star = self.mesh.all_gather_shards(star_loc)
        nc_star = self._nc(star) if self.strip is not None else None
        cnt_star = (_at_color(nc_star, star[:, off:off + n_loc]) if nc_star is not None
                    else self._cnt_of(star))
        accepted = torch.ones(len(ks), dtype=torch.bool, device=dev)
        if p.hastings:
            cnt_c = st.cnt.index_select(0, idx)
            logq_old = torch.stack([
                self._reverse_logq(cf[j], star[j], eps_t, None if nc_star is None else nc_star[j])
                for j in range(len(ks))])
            mine = torch.stack([logq_star.double(), logq_old.double(),
                                cnt_star.sum(1, dtype=torch.int64).double(),
                                cnt_c.sum(1, dtype=torch.int64).double(),
                                torch.log(u_acc.clamp(min=1e-30)).double()], 1)
            got = self.mesh.gather_shards_host(mine)  # [ms, k, 5]
            ls, lo = np.zeros(len(ks), np.float32), np.zeros(len(ks), np.float32)
            for s in range(got.shape[0]):  # float32 psums, in shard order
                ls, lo = ls + got[s, :, 0].astype(np.float32), lo + got[s, :, 1].astype(np.float32)
            conf_star = got[:, :, 2].sum(0).astype(np.int64) // 2
            conf_old = got[:, :, 3].sum(0).astype(np.int64) // 2
            log_ratio = (np.float32(-p.lambda_) * (conf_star - conf_old).astype(np.float32)
                         + lo - ls)
            acc = got[0, :, 4].astype(np.float32) < log_ratio
            accepted = torch.from_numpy(acc).to(dev)
            star = torch.where(accepted[:, None], star, cf)
            cnt_star = torch.where(accepted[:, None], cnt_star, cnt_c)
        return star, new_tb, cnt_star, accepted

    def _reverse_logq(self, cf: torch.Tensor, star: torch.Tensor, eps_t,
                      nc_star: torch.Tensor | None = None) -> torch.Tensor:
        """Σ log q(old | star) over the rank's rows (JAX's
        ``reverse_logq_loc``): the occupancy of the STAR colouring, one
        gather a row band, or read from the strip's NC(star) (JAX's
        ``reverse_logq_nc``)."""
        off = self.offset
        if nc_star is not None:
            return _reverse_logq_nc(nc_star, cf[off:off + self.n_loc],
                                    star[off:off + self.n_loc], self._real_loc, self.params,
                                    self._prop_block, eps_t)
        total = torch.zeros((), dtype=torch.float32, device=cf.device)
        for s, e in _bands(self.n_real, self.d_pad):
            occ = occupancy_matrix(neighbor_colors(self.neighbors[s:e], star), self.params.n_colors)
            q_old = _reverse_q(occ, cf[off + s:off + e], star[off + s:off + e],
                               self.params.n_colors, eps_t)
            total += torch.log(q_old.clamp(min=1e-30)).sum()
        return total

    def _active_branch(self, st: ShardedState, k: int, eps_t, eps_eff, p_per):
        """Frontier sweep of local chain ``k`` (JAX's ``active_branch``):
        resample only the ≤ cap eligible rows of this rank (cnt > 0, taboo
        0) with K2 and their global ids as ``self_ids``; the passive rows'
        taboo dynamics and at most one ε-flip; cnt kept exactly from the
        changed rows through one all-gather of ``colour << 1 | changed``
        and one all-reduce of the delta.  Returns (colours [n_pad], taboo,
        cnt [n_loc])."""
        p, n, off, n_loc, n_pad = self.params, self.graph.n, self.offset, self.n_loc, self.n_pad
        cap, dev, real = self.active_cap, self.device, self._real_loc
        n_colors, t_iter = p.n_colors, p.taboo_iterations
        cf, tb, cnt_c, src = st.colors[k], st.taboo[k], st.cnt[k], st.sources[k]
        lids, lvalid = frontier_ids((cnt_c > 0) & (tb == 0) & real, cap)  # sentinel n_loc
        lids_l = lids.clamp(max=n_loc - 1).to(torch.int64)
        gids = torch.where(lvalid, off + lids, n_pad)
        # the valid ids come first: at most the frontier's size over the
        # shards, which the host read with the last sweep's statistics
        rows = self._rows(lids_l, lvalid, int(st.stats[self._local_chains()[k], 0]))
        cur = torch.where(lvalid, cf[gids.clamp(max=n_pad - 1).to(torch.int64)], n_colors)
        p_eff = _p_eff(cf[None], p, n, self._full_real)
        s = self.mesh.shard_index
        u = src.next(self.mesh.shards * cap).to(dev)[s * cap:(s + 1) * cap].contiguous()
        chosen, _, new_tb_a, _ = self._sweep_fn()(
            rows, cf[:n].contiguous(), cur, torch.zeros((cap,), dtype=torch.int32, device=dev),
            0, u, None if p_eff is None else p_eff[0], eps_t, p, self_ids=gids)
        chosen = torch.where(lvalid, chosen, cur)

        # sparse ε-flip: with prob 1-(1-(nCol-1)ε)^|passive| one passive
        # vertex redraws a non-current colour (a chain-level decision: the
        # chain's draws are the same on every shard; only the owner can
        # find the vertex passive, so no shard sum is needed for it)
        passive = (cnt_c == 0) & (tb == 0) & real
        n_passive = np.float32(st.stats[self._local_chains()[k], 2])
        p_any = np.float32(1.0) - np.exp(n_passive * np.log1p(-p_per))
        do_flip = src.next(1).to(dev) < float(p_any)
        fv = src.randint(1, n).to(dev)
        offs = src.randint(1, max(n_colors, 2), low=1).to(dev)
        fv_lid = fv - off
        fv_lid_c = fv_lid.clamp(0, n_loc - 1).to(torch.int64)
        fv_elig = (fv_lid >= 0) & (fv_lid < n_loc) & passive[fv_lid_c]
        x_valid = do_flip & fv_elig
        fv_old = cf[fv.to(torch.int64)]
        fv_new = torch.remainder(fv_old + offs, n_colors).to(torch.int32)
        x_lid = torch.where(x_valid, fv_lid_c.to(torch.int32), n_loc)
        x_row = self._rows(fv_lid_c, x_valid)

        # the changed slots: the frontier and the flip slot
        lids2 = torch.cat([lids, x_lid])
        lvalid2 = torch.cat([lvalid, x_valid])
        old2 = torch.cat([cur, fv_old])
        new2 = torch.cat([chosen, torch.where(x_valid, fv_new, fv_old)])
        rows2 = torch.cat([rows, x_row])

        # taboo: locked counts down, the passive keep-draw re-arms it, the
        # frontier takes K2's, the flipped vertex 0
        tb_next = torch.where(tb > 0, tb - 1, real.to(torch.int32) * t_iter)
        tb_next = scatter_drop(tb_next, lids, new_tb_a)
        tb_next = scatter_drop(tb_next, x_lid, 0)

        star_loc = scatter_drop(cf[off:off + n_loc], lids2, torch.where(lvalid2, new2, 0))
        changed2 = lvalid2 & (new2 != old2)
        changed_loc = scatter_drop(torch.zeros((n_loc,), dtype=torch.int32, device=dev), lids2,
                                   changed2.to(torch.int32))
        # one all-gather moves the new colours and the changed flags; the
        # sentinel -2 decodes to colour -1, unchanged
        packed = self.mesh.all_gather_shards((star_loc << 1) | changed_loc)
        star = packed >> 1
        packed_ext = torch.cat([packed, torch.full((1,), -2, dtype=torch.int32, device=dev)])
        nb2 = packed_ext.index_select(0, rows2.reshape(-1)).view(rows2.shape)
        t_changed = (nb2 & 1) == 1
        t_color = nb2 >> 1
        # deltas to unchanged neighbours (a changed neighbour's own recount
        # covers this vertex), plus exact recounts of the changed vertices
        same_new = (t_color == new2[:, None]).to(torch.int32)
        contrib = torch.where(changed2[:, None] & ~t_changed,
                              same_new - (t_color == old2[:, None]).to(torch.int32), 0)
        delta = _add_spread(n_pad, rows2.reshape(-1), contrib.reshape(-1))
        recount = same_new.sum(1, dtype=torch.int32)
        cnt_old2 = cnt_c[lids2.clamp(0, n_loc - 1).to(torch.int64)]
        self_t = torch.where(changed2, off + lids2.clamp(max=n_loc - 1), n_pad)
        delta = scatter_drop(delta, self_t, torch.where(changed2, recount - cnt_old2, 0),
                             accumulate=True)
        delta = self.mesh.all_reduce_shards(delta)
        return star, tb_next, cnt_c + delta[off:off + n_loc]

    def _rows(self, lids: torch.Tensor, valid: torch.Tensor, n_valid: int | None = None
              ) -> torch.Tensor:
        """Neighbour ids of this rank's rows ``lids`` (local, int64), the
        padding id ``n_pad`` in every slot of an invalid row: the ELL's
        rows, or on the resident graph the strip's rows unpacked to
        ascending ids (JAX ``rows_from_strip``; every consumer is
        order-invariant).  ``n_valid`` bounds the valid rows, which come
        first: the strip unpacks only those (the unpack of a strip row
        writes n_pad ints; JAX unpacks all ``cap``)."""
        if self.neighbors is not None:
            rows = self.neighbors.index_select(0, lids)
        else:
            m = lids.shape[0] if n_valid is None else min(n_valid, lids.shape[0])
            rows = torch.full((lids.shape[0], self.d_row), self.n_pad, dtype=torch.int32,
                              device=lids.device)
            rows[:m] = packed_rows_to_ids(self.strip.index_select(0, lids[:m]), self.d_row,
                                          self.n_pad)
        return torch.where(valid[:, None], rows, self.n_pad)

    # ---- the sharded tailcut (JAX's _run_tailcut_sharded) ------------------

    def _tailcut(self, colors_full: torch.Tensor, source):
        """Rank-space tail-cutting of one colouring (replicated [n_pad]),
        each shard over its own rows, in budgeted segments.  Returns
        (colours [n_pad], conflicts read before the last round,
        rounds)."""
        from mcmc_colorer_tpu_torch.utils.segmented import drive_segments

        p, n = self.params, self.graph.n
        cols_r, ordered = _sharded_tailcut_rank(colors_full, p.n_colors, n)
        max_rounds = n + 1000

        def segment(c, budget):
            cols, conf, rounds, done = c
            limit = min(rounds + self._agree(budget), max_rounds)
            while not done and rounds < limit:
                cols, conf = self._tailcut_round(cols, rounds, source)
                rounds, done = rounds + 1, conf == 0
            return cols, conf, rounds, done or conf == 0

        tc = drive_segments(segment, (cols_r, 2**30, 0, False), lambda c: (c[2], c[3]))
        return _sharded_tailcut_unrank(tc[0], ordered, p.n_colors, n), tc[1], tc[2]

    def _tailcut_round(self, cols_r: torch.Tensor, rounds: int, source):
        """One round over this rank's rows: conflicted rows with a first
        free colour (K3) and no lower-id movable neighbour move to it; when
        no row anywhere can move, the conflicted rows take the round's
        random colours (the stall escape).  Returns (new rank-space
        colours [n_pad], the conflicts of ``cols_r``)."""
        from mcmc_colorer_tpu_torch.ops.firstfit import first_fit

        p, n, off, nr, n_loc = self.params, self.graph.n, self.offset, self.n_real, self.n_loc
        dev = cols_r.device
        gids = self._gids
        own = cols_r[off:off + n_loc]
        flags = torch.zeros((n_loc,), dtype=torch.bool, device=dev)
        conf = torch.zeros((), dtype=torch.int64, device=dev)
        for s, e in _bands(nr, self.d_pad):
            nb = self.neighbors[s:e]
            same = neighbor_colors(nb, cols_r) == own[s:e, None]
            conf += (same & (nb > gids[s:e, None])).sum()
            flags[s:e] = same.any(1)
        cand = torch.full((n_loc,), -1, dtype=torch.int32, device=dev)
        allow = torch.ones((p.n_colors,), dtype=torch.int32, device=dev)
        cand[:nr] = first_fit(self.neighbors[:nr], cols_r, allow, p.n_colors)
        movable = flags & (cand >= 0)
        movable_full = self.mesh.all_gather_shards(movable.to(torch.int32)) > 0
        movable_ext = torch.cat([movable_full, torch.zeros((1,), dtype=torch.bool, device=dev)])
        lower = torch.zeros((n_loc,), dtype=torch.bool, device=dev)
        for s, e in _bands(nr, self.d_pad):
            nb = self.neighbors[s:e]
            lower[s:e] = (movable_ext.index_select(0, nb.reshape(-1)).view(nb.shape)
                          & (nb < gids[s:e, None])).any(1)
        active = movable & ~lower
        got = self.mesh.gather_shards_host(torch.stack([conf, active.sum()]))
        conf_h, any_active = int(got[:, 0].sum()), bool(got[:, 1].sum() > 0)
        rnd = source.randint(n, p.n_colors).to(dev)[off:off + nr]
        stalled = conf_h > 0 and not any_active
        new_loc = torch.where(active, cand, own)
        if stalled:
            new_loc[:nr] = torch.where(flags[:nr], rnd, new_loc[:nr])
        return self.mesh.all_gather_shards(new_loc), conf_h


    # ---- the strip-native tailcut (JAX's _tailcut_strips_round) -------------

    def _tailcut_strips(self, colors_full: torch.Tensor, conflicts: int, source):
        """Independent-set repair rounds of one colouring (replicated
        [n_pad]) over the strips while conflicts remain, at most 16 + 2 ·
        the entry conflicts (JAX ``run``, sharded.py:575-616), each round's
        exit NC the next round's entry NC; where the cap leaves conflicts
        in a colouring whose chain converged (it came in with at most the
        tailcut threshold z), the serial first-free pass
        (``_finish_strips``, a deliberate difference from JAX, as on one
        card).  Returns (colours, conflicts at the end, rounds)."""
        converged = conflicts <= self.params.tailcut_threshold(self.graph.n)
        cap, rounds, nc = 16 + 2 * conflicts, 0, None
        while conflicts > 0 and rounds < cap:
            colors_full, conflicts, nc = self._tailcut_strips_round(
                colors_full, source.next(self.n_pad), nc)
            rounds += 1
        if conflicts > 0 and converged:
            del nc
            colors_full, conflicts = self._finish_strips(colors_full)
        return colors_full, conflicts, rounds

    def _finish_strips(self, cols: torch.Tensor):
        """The single-card tailcut's end (``mcmc_resident._finish_first_free``)
        over the strips: every vertex in a conflict, one at a time in id
        order, takes its smallest colour that no neighbour holds
        (``_free_color_of_row`` on its strip row, by the rank that holds
        it; one all-gather over the shard group hands the colour to every
        rank).  Returns (colours [n_pad], global conflicts)."""
        p, off, n_loc, real = self.params, self.offset, self.n_loc, self._real_loc
        nc = self._nc(cols)
        bad_loc = (_at_color(nc, cols[off:off + n_loc]) > 0) & real
        del nc
        bad = self.mesh.all_gather_shards(bad_loc.to(torch.int32))
        cols = cols.clone()
        for v in torch.nonzero(bad).flatten().tolist():
            s = v // n_loc
            mine = torch.full((1,), -1, dtype=cols.dtype, device=cols.device)
            if s == self.mesh.shard_index:
                mine[0] = _free_color_of_row(self.strip[v - off], cols, p.n_colors, int(cols[v]))
            cols[v] = self.mesh.all_gather_shards(mine)[s]
        own = cols[off:off + n_loc]
        cnt = torch.where(real, _at_color(self._nc(cols), own), 0).sum()
        return cols, int(self.mesh.gather_shards_host(cnt).sum()) // 2

    def _tailcut_strips_round(self, cols: torch.Tensor, coins: torch.Tensor,
                              nc_prev: torch.Tensor | None = None):
        """One round over this rank's strip rows (JAX
        ``_tailcut_strips_round``): its conflicted rows flip ``coins`` (its
        rows of the round's [n_pad] uniforms) and the heads go round the
        shard group in one all-gather; a head with no head neighbour (one
        ``strip & head_bits`` pass) moves to its first NC-free colour (the
        least occupied where none is free), and a second all-gather
        publishes the colours.  Movers are pairwise non-adjacent and land
        on colours free in their whole neighbourhood, so conflicts never
        rise while free colours exist.  ``nc_prev``: the previous round's
        exit NC of ``cols`` (skips the entry K1 launch).  Returns (colours
        [n_pad], global conflicts, exit NC)."""
        p, off, n_loc, real = self.params, self.offset, self.n_loc, self._real_loc
        nc = self._nc(cols) if nc_prev is None else nc_prev
        own = cols[off:off + n_loc]
        heads = (_at_color(nc, own) > 0) & real & (coins.to(cols.device)[off:off + n_loc] < 0.5)
        heads_full = self.mesh.all_gather_shards(heads.to(torch.int32)) > 0
        movers = heads & ~_any_neighbor_in(self.strip, _pack_mask(heads_full, self.strip.shape[1]))
        newc = _first_free(nc, p.n_colors)
        cols_new = self.mesh.all_gather_shards(torch.where(movers, newc, own))
        del nc
        nc2 = self._nc(cols_new)
        cnt2 = torch.where(real, _at_color(nc2, cols_new[off:off + n_loc]), 0).sum()
        return cols_new, int(self.mesh.gather_shards_host(cnt2).sum()) // 2, nc2


# the delta's zero terms (most of a frontier's slots) are added into this
# many spare slots, spread by position, not into one: atomics on a single
# padding slot serialise (~2 ms a frontier sweep at a cap of 12,544 rows
# of 1,152 slots, on an H100)
_SPREAD_SLOTS = 4096


def _add_spread(n: int, ids: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """[n] int32: ``values`` summed at ``ids`` (JAX's ``.at[ids].add(...,
    mode="drop")``); the zero values go to the spare slots instead."""
    dev = ids.device
    spare = n + torch.arange(ids.numel(), device=dev, dtype=torch.int32) % _SPREAD_SLOTS
    out = torch.zeros((n + _SPREAD_SLOTS,), dtype=torch.int32, device=dev)
    out.index_add_(0, torch.where(values != 0, ids, spare), values)
    return out[:n]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sharded_tailcut_rank(colors_full: torch.Tensor, n_colors: int, n_nodes: int):
    """Rank-space relabel by ascending class size (a stable sort, as
    ``jnp.argsort``; the reference's orderedIndex sort,
    coloringMCMC_main.cu:275-279).  Returns (cols_r, ordered)."""
    dev = colors_full.device
    real = torch.arange(colors_full.shape[0], device=dev) < n_nodes
    hist = color_histogram(colors_full, n_colors, real)
    ordered = torch.argsort(hist, stable=True).to(torch.int32)
    rank = torch.zeros((n_colors + 1,), dtype=torch.int32, device=dev)
    rank[ordered.to(torch.int64)] = torch.arange(n_colors, dtype=torch.int32, device=dev)
    rank[n_colors] = n_colors
    cols_r = rank[colors_full.clamp(0, n_colors).to(torch.int64)]
    return torch.where(real, cols_r, n_colors), ordered


def _sharded_tailcut_unrank(cols_r: torch.Tensor, ordered: torch.Tensor, n_colors: int,
                            n_nodes: int) -> torch.Tensor:
    dev = cols_r.device
    real = torch.arange(cols_r.shape[0], device=dev) < n_nodes
    ordered_ext = torch.cat([ordered, torch.full((1,), n_colors, dtype=torch.int32, device=dev)])
    out = ordered_ext[cols_r.clamp(0, n_colors).to(torch.int64)]
    return torch.where(real, out, n_colors)
