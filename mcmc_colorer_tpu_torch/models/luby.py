"""Luby-inspired greedy MIS colorer.

Counterpart of ``mcmc_colorer_tpu/models/luby.py``: peel
off maximal independent sets, one per colour.  A round flips a coin for
every candidate (``u < 0.5``); a selected vertex survives iff its degree
exceeds that of every selected neighbour (ties eliminate both,
check_conflicts_k of coloringLuby.cu:269-276); survivors join the set and
they and their neighbours leave the candidates.  When no candidate is
left the set is committed as the next colour and the candidates reset to
the uncoloured vertices.

Three loops, all with the same rule and the same draws:

- the gather loop over the ELL, flat or degree-bucketed (``_run_luby``):
  one ``next(n_pad)`` a round;
- the frontier loop (``active=True``, ``_luby_active_round``): gathers
  only the candidates' rows, one ``next(cap)`` a round;
- the matmul loop (``_run_luby_matmul``), on a hash-defined G(n, p)
  built on the device (``resident_spec``) or on a host graph with
  ``backend="matmul"`` (A built on the device from its ELL,
  ``ops/dense_adj.get_adjacency``): both neighbour inspections are
  neighbour colour counts over the bit-packed adjacency, kernel K1 on
  the card.  On the same adjacency and draws its colouring equals the
  gather loop's.

All decisions are integer or ``u < 0.5`` comparisons, so fed JAX's
uniforms (``utils/rng.py``) the colourings equal JAX's bit for bit.
``layout="bucketed"`` relabels the graph by descending degree and lays it
out in classes of widths ``8 · 4^k`` (JAX's ``min_lane=8``); the gather
and frontier loops then inspect a degree class at a time.  The matmul
loop and resident graphs are flat only, as in JAX.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mcmc_colorer_tpu_torch.graph.container import Graph
from mcmc_colorer_tpu_torch.models.base import (
    Coloring,
    bucketed_layout,
    colorer_device,
    colors_in_input_order,
)
from mcmc_colorer_tpu_torch.models.mcmc import _row_blocks, _sync
from mcmc_colorer_tpu_torch.models.mcmc_active import (
    DEFAULT_BUCKET_FACTOR,
    _buckets,
    pick_cap,
    round_range,
)
from mcmc_colorer_tpu_torch.models.mcmc_resident import _round_up, _StatsShim
from mcmc_colorer_tpu_torch.ops.dense_adj import (
    PACKED_ADJ_MAX_N,
    get_adjacency,
    neighbor_color_counts,
    packed_adj_bytes,
)
from mcmc_colorer_tpu_torch.ops.hashgen import (
    er_packed_on_device_cached,
    hash_er_graph,
)
from mcmc_colorer_tpu_torch.ops.neighbor import frontier_ids, scatter_drop, take_rows
from mcmc_colorer_tpu_torch.utils.rng import TorchUniformSource


class LubyColorer:
    """``graph``: a host ``Graph``, or None with ``resident_spec = (n, p,
    graph_seed)`` for the hash-defined G(n, p) built on the device.
    ``backend``: ``auto`` runs the gather loop on a host graph and the
    matmul loop on a resident spec; ``matmul`` (or ``packed``, the same
    adjacency here) runs the matmul loop on either.
    ``device``: the current CUDA device by default (``colorer_device``);
    the CPU only when asked for."""

    def __init__(
        self,
        graph: Graph | None,
        active: bool = False,
        min_bucket: int = 128,
        bucket_factor: int | None = None,
        layout: str = "flat",
        backend: str = "auto",
        resident_spec: tuple | None = None,
        device="cuda",
    ) -> None:
        if layout not in ("flat", "bucketed"):
            raise ValueError(f"unknown layout {layout!r}")
        self.active = active
        self._perm = self._pos = None
        self._min_bucket = min_bucket
        self._bucket_factor = bucket_factor or DEFAULT_BUCKET_FACTOR
        if resident_spec is not None:
            if graph is not None:
                raise ValueError("pass graph=None with resident_spec")
            if active or layout != "flat":
                raise ValueError(
                    "resident Luby runs the flat full matmul loop only (the frontier "
                    "and bucketed variants gather neighbour rows the resident graph "
                    "never has)"
                )
            if backend not in ("auto", "matmul"):
                raise ValueError(f"resident_spec implies backend='matmul'; got {backend!r}")
            self.device = colorer_device(device)
            self._init_resident(*resident_spec)
            return
        if backend not in ("auto", "matmul", "packed"):
            raise ValueError(
                f"backend={backend!r}: Luby over a host graph has two backends, "
                "the gather loop ('auto') and the matmul loop ('matmul')"
            )
        matmul = backend != "auto"
        if matmul and (active or layout != "flat"):
            raise ValueError("backend='matmul' serves the flat full loop only")
        self.backend = "matmul" if matmul else "gather"
        self.device = colorer_device(device)
        self.graph = graph
        # the full loop draws n_pad uniforms a round: JAX's padding, so
        # both packages consume the same stream
        if layout == "bucketed":
            self.ell, self._perm, self._pos = bucketed_layout(
                graph, descending=True, min_lane=8, device=self.device)
        else:
            self.ell = graph.to_ell(pad_nodes_to=128 if active or matmul else 8,
                                    device=self.device)
        if matmul:
            self.node_mask = self.ell.node_mask
            self._set_rank_classes(graph.degrees, self.ell.degrees)
            self.adj = get_adjacency(graph, self.ell)

    def _set_rank_classes(self, degrees: np.ndarray, padded: torch.Tensor) -> None:
        """Each vertex's index into the ascending table of the real
        vertices' distinct degrees (the matmul loop's survival test)."""
        uniq = np.unique(degrees)
        rank = np.searchsorted(uniq, padded.cpu().numpy()).astype(np.int32)
        self.rank_class = torch.from_numpy(rank).to(self.device)
        self.n_classes = int(uniq.size)

    def _init_resident(self, n: int, p: float, graph_seed: int) -> None:
        self.backend = "matmul"
        self.resident_spec = (n, p, graph_seed)
        n_pad = _round_up(n, 2048)
        if n_pad > PACKED_ADJ_MAX_N:
            raise ValueError(
                f"resident graphs are bound to the packed-adjacency HBM cap: "
                f"n_pad={n_pad} > {PACKED_ADJ_MAX_N} "
                f"({packed_adj_bytes(n_pad) / 1e9:.1f} GB of A bits)"
            )
        self.n_pad = n_pad
        # the same cache slot as ResidentMCMCColorer: both colorers of one
        # hash graph share one device adjacency
        self.adj, degrees = er_packed_on_device_cached(n, p, graph_seed, n_pad,
                                                       device=self.device)
        host_degrees = degrees[:n].cpu().numpy()
        max_degree = int(host_degrees.max()) if n else 0
        n_edges = int(host_degrees.astype(np.int64).sum() // 2)
        self.graph = _StatsShim(n, n_edges, host_degrees, max_degree, f"er_hash_{n}_{p}")
        self.node_mask = torch.arange(n_pad, device=self.device) < n
        self._set_rank_classes(host_degrees, degrees)

    def host_graph(self):
        """Resident specs only: host CSR of the same hash graph (threaded
        C++ enumeration), for validation."""
        if not hasattr(self, "resident_spec"):
            raise ValueError("host_graph() is for resident_spec colorers")
        n, p, seed = self.resident_spec
        return hash_er_graph(n, p, seed, name=self.graph.name)

    def _run_active(self, source):
        """Host-driven frontier loop: (colours, colours used, rounds)."""
        ell = self.ell
        caps = _buckets(ell.n_pad, self._min_bucket, self._bucket_factor)
        colors = torch.where(ell.node_mask, -1, 0).to(torch.int32)
        uncolored, n_colors, rounds = self.graph.n, 0, 0
        while uncolored > 0:
            cands = (colors < 0) & ell.node_mask
            is_set = torch.zeros_like(cands)
            n_cand = uncolored
            while n_cand > 0:
                cap = pick_cap(caps, n_cand)
                with round_range("luby", cap):
                    cands, is_set, n_c = _luby_active_round(ell, cands, is_set, source.next(cap))
                    n_cand = int(n_c)
                rounds += 1
            colors = torch.where(is_set, n_colors, colors)
            uncolored = int(((colors < 0) & ell.node_mask).sum())
            n_colors += 1
        return colors, n_colors, rounds

    def run(self, seed: int, repetition: int = 0, source=None) -> Coloring:
        """Colour the graph.  ``source`` (tests) replaces the run's
        uniform source (``utils/rng.py``)."""
        dev = self.device
        source = source or TorchUniformSource(seed, repetition, dev)
        _sync(dev)
        t0 = time.perf_counter()
        if self.active:
            colors, n_colors, rounds = self._run_active(source)
        elif self.backend == "matmul":
            colors, n_colors, rounds = _run_luby_matmul(
                self.adj, self.rank_class, self.node_mask, source, n_classes=self.n_classes)
        else:
            colors, n_colors, rounds = _run_luby(self.ell, source)
        colors = colors_in_input_order(colors, self.graph.n, self._perm, self._pos)
        dur = (time.perf_counter() - t0) * 1e3
        return Coloring(
            colors=colors,
            n_colors=n_colors,
            iterations=n_colors,
            converged=True,
            duration_ms=dur,
            extra={"rounds": rounds},
        )


def _luby_active_round(ell, cands, is_set, u):
    """One coin-flip / survival / prune round over the <= ``cap =
    len(u)`` candidates, gathering only their rows.  A neighbour's
    selection flag and degree travel in one int32 (deg * 2 | selected).
    Returns (cands, is_set, number of candidates left)."""
    n_pad = ell.n_pad
    ids, valid = frontier_ids(cands, u.shape[0])
    sel = valid & (u < 0.5)
    sel_full = scatter_drop(torch.zeros_like(cands), ids, sel)
    rows = take_rows(ell, ids, valid)
    packed = torch.cat([(ell.degrees << 1) | sel_full.to(torch.int32),
                        ell.degrees.new_zeros((1,))])
    nb = packed.index_select(0, rows.reshape(-1)).reshape(rows.shape)
    deg = ell.degrees[ids.clamp(max=n_pad - 1).to(torch.int64)]
    # survive iff deg_i > deg_j for every selected neighbour j (ties kill both)
    beaten = (((nb & 1) == 1) & ((nb >> 1) >= deg[:, None])).any(1)
    surv = sel & ~beaten
    surv_full = scatter_drop(torch.zeros_like(cands), ids, surv)
    is_set = is_set | surv_full
    cands = cands & ~surv_full
    # neighbours of survivors leave the candidates (only the survivors'
    # rows are scattered, not the whole [cap, d_pad] band)
    cands = scatter_drop(cands, rows[surv].reshape(-1), False)
    return cands, is_set, cands.sum()


def _luby_loop(node_mask, source, survivors, near):
    """The flattened loop: the reference's host loop per colour around a
    kernel loop per MIS round (coloringLuby.cu:83-176) as one loop whose
    round commits the set as a colour when it empties the candidates.
    ``survivors(sel)`` applies the survival rule, ``near(surv)`` marks
    the survivors' neighbours.  One ``next(n_pad)`` and one host read a
    round.  Returns (colours, colours used, rounds)."""
    colors = torch.where(node_mask, -1, 0).to(torch.int32)
    # the candidates start as all uncoloured vertices (prune_eligible,
    # coloringLuby.cu:223-228)
    cands, is_set = node_mask.clone(), torch.zeros_like(node_mask)
    n_colors, rounds, done = 0, 0, not bool(node_mask.any())
    while not done:
        sel = cands & (source.next(cands.shape[0]) < 0.5)  # set_initial_distr_k
        surv = survivors(sel)
        is_set = is_set | surv
        cands = cands & ~surv & ~near(surv)
        rounds += 1
        if not bool(cands.any()):
            # add_color_and_check_uncolored_k (coloringLuby.cu:328-341)
            colors = torch.where(is_set, n_colors, colors)
            n_colors += 1
            cands = (colors < 0) & node_mask
            is_set = torch.zeros_like(is_set)
            done = not bool(cands.any())
    return colors, n_colors, rounds


def _run_luby(ell, source):
    """The gather loop over either ELL layout, a row block at a time (a
    band of the flat ELL, or a degree-class rectangle: JAX's
    ``_luby_segment_bucketed``); a neighbour's selection flag and degree
    travel in one int32 gather."""
    degs = ell.degrees

    def survivors(sel):
        packed = torch.cat([(degs << 1) | sel.to(torch.int32), degs.new_zeros((1,))])
        beaten = torch.empty_like(sel)
        for s, neigh in _row_blocks(ell):
            e = s + neigh.shape[0]
            nb = packed.index_select(0, neigh.reshape(-1)).reshape(neigh.shape)
            # survive iff deg_i > deg_j for every selected neighbour j
            beaten[s:e] = (((nb & 1) == 1) & ((nb >> 1) >= degs[s:e, None])).any(1)
        return sel & ~beaten

    def near(surv):
        ext = torch.cat([surv, surv.new_zeros((1,))])
        out = torch.empty_like(surv)
        for s, neigh in _row_blocks(ell):
            e = s + neigh.shape[0]
            out[s:e] = ext.index_select(0, neigh.reshape(-1)).reshape(neigh.shape).any(1)
        return out

    return _luby_loop(ell.node_mask, source, survivors, near)


def _run_luby_matmul(adj, rank_class, node_mask, source, *, n_classes: int):
    """The loop with both neighbour inspections as neighbour colour
    counts over the packed adjacency (K1 on the card): (1) the selected
    vertices coloured by their degree class, and a suffix count over the
    classes at the vertex's own class says "some selected neighbour has
    a degree >= mine", the survival rule with its ties; (2) the
    survivors in one class mark their neighbours."""
    cls_ids = torch.arange(n_classes, device=adj.device)[None, :]

    def survivors(sel):
        m = neighbor_color_counts(adj, torch.where(sel, rank_class, -1), n_classes)
        ge_cnt = torch.where(cls_ids >= rank_class[:, None], m[:, :n_classes], 0).sum(1)
        return sel & ~(ge_cnt > 0)

    def near(surv):
        return neighbor_color_counts(adj, torch.where(surv, 0, -1).to(torch.int32), 1)[:, 0] > 0

    return _luby_loop(node_mask, source, survivors, near)
