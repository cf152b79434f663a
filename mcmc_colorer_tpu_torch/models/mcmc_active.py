"""The frontier (active-set) MCMC chain and its capacity ladder.

Counterpart of ``mcmc_colorer_tpu/models/mcmc_active.py``.  At the
reference's ε = 1e-8 a vertex with no conflict keeps its colour with
probability 1 - (nCol - 1)·ε ≈ 1, so only the conflicting vertices
really move.  ``ActiveMCMCColorer`` runs full sweeps (kernel K2, one
launch a sweep) until ``2·conflicts < n_pad // 8``, measured on the
colouring each sweep starts from, and then frontier iterations:

- the frontier is the conflicting vertices whose taboo is 0
  (``cnt > 0``), at most ``cap`` of them, ``cap`` the smallest rung of
  the ladder (``_buckets``, factor 4) that holds them;
- K2 resamples the frontier's rows only, with their own ids as
  ``self_ids`` (on the CPU its plain version);
- the rest keep their colours: their taboo counts down or is re-armed,
  and at most one of them flips its colour (the ε-flip: the one chance
  an iteration that any of them draws another colour);
- ``cnt`` (same-colour neighbours a vertex) is kept up to date from the
  frontier's rows, then from the flipped vertex's row.

A frontier tailcut (``_tailcut_round``, conflicting vertices move to
their first free colour in ascending class-size order) repairs what is
left.  The resident chain (``models/mcmc_resident.py``, ``active=True``)
runs the same frontier iterations with rows unpacked from its packed
adjacency (``PackedRows``) and ``cnt`` counted by K1.

The draws follow ``utils/rng.py``.  JAX scatters the frontier's taboo and
``cnt`` through ids clamped to ``n_pad - 1`` (mcmc_active.py:476-479,
503-506), so its padding rows write to vertex ``n_pad - 1`` as well; the
port writes the valid rows only (``ops/neighbor.scatter_drop``).  Where
JAX counts ``cnt`` afresh after an ε-flip (``lax.cond``, :509-522), the
port updates it from the flipped vertex's row: both are exact, and the
port's needs neither a host branch nor a pass over the graph.  An
iteration reads the host once, for its statistics: the frontier is
gathered by a prefix count (``ops/neighbor.frontier_ids``), the class
histogram by ``index_add_``, and no scalar is copied from the host.

The ladder serves the port's other frontier colourers too (``greedy_ff``,
``vff``, ``luby`` with ``active=True``).  ``layout="bucketed"`` runs the
full sweeps once a degree-class rectangle and gathers the frontier's rows
from the classes (``ops/neighbor.take_rows``), at the widest class's
width; K2 then looks the neighbours up in the whole padded colour vector.
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from mcmc_colorer_tpu_torch.config import MCMCParams
from mcmc_colorer_tpu_torch.graph.container import Graph, degree_pad_for
from mcmc_colorer_tpu_torch.models.base import (
    Coloring,
    bucketed_layout,
    colorer_device,
    colors_in_input_order,
)
from mcmc_colorer_tpu_torch.models.mcmc import (
    _at_color,
    _conflict_edges,
    _init_colors,
    _lookup_colors,
    _p_eff_of,
    _row_blocks,
    _sweep,
    _sweep_pallas_fused,
    _sync,
    choose_block_size,
)
from mcmc_colorer_tpu_torch.ops.dense_adj import neighbor_color_counts, packed_rows_to_ids
from mcmc_colorer_tpu_torch.ops.neighbor import (
    color_histogram,
    frontier_ids,
    neighbor_colors,
    occupancy_matrix,
    scatter_drop,
    take_rows,
)
from mcmc_colorer_tpu_torch.ops.resample import resample_sweep, resample_sweep_plain
from mcmc_colorer_tpu_torch.utils.rng import TorchUniformSource
from mcmc_colorer_tpu_torch.utils.spans import span

DEFAULT_BUCKET_FACTOR = 4


def _buckets(n_pad: int, min_bucket: int = 128, factor: int = DEFAULT_BUCKET_FACTOR) -> list[int]:
    """Frontier-capacity ladder: multiples of 128 from ``min_bucket``
    growing by ``factor`` (at least 2), closed by ``n_pad``."""
    out = []
    b = max(128, ((min_bucket + 127) // 128) * 128)
    factor = max(2, factor)
    while b < n_pad:
        out.append(b)
        b *= factor
    out.append(n_pad)
    return out


def pick_cap(caps: list[int], count: int) -> int:
    """Smallest ladder capacity holding ``count`` frontier vertices."""
    return next(c for c in caps if c >= max(count, 1))


def round_range(loop: str, cap: int):
    """A profiler range around one frontier round, named by its loop and
    its cap, so that a profiler trace of a run groups the rounds by loop
    and cap; without a profiler the shared no-op span
    (``utils/spans.py``)."""
    return span(f"{loop} round cap={cap}")


# ------------------------- the frontier's rows -------------------------


@dataclass
class PackedRows:
    """A resident graph as the frontier sees it: rows unpacked from the
    packed adjacency ``adj`` to ``d_row`` ascending ids each, and ``cnt``
    counted by K1.  Every consumer of a row is order-invariant, so these
    rows and a stored ELL's are interchangeable."""

    adj: torch.Tensor        # [n_pad, words] int32
    d_row: int
    n_nodes: int
    node_mask: torch.Tensor  # [n_pad] bool

    @property
    def n_pad(self) -> int:
        return self.adj.shape[0]


def _rows_of(graph, ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[cap, d] neighbour ids of the frontier ``ids`` (the sentinel
    ``n_pad`` in every slot of an invalid row): gathered from the ELL, or
    sliced from the packed adjacency and unpacked."""
    if not isinstance(graph, PackedRows):
        return take_rows(graph, ids, valid)
    n_pad = graph.n_pad
    bits = graph.adj.index_select(0, ids.clamp(max=n_pad - 1))
    rows = packed_rows_to_ids(bits, graph.d_row, n_pad)
    return torch.where(valid[:, None], rows, n_pad)


def _stats(cnt: torch.Tensor, taboo: torch.Tensor) -> torch.Tensor:
    """[2] int64 on the device: the frontier's size (conflicting vertices
    whose taboo is 0) and the conflict edges (Σ cnt / 2)."""
    return torch.stack([((cnt > 0) & (taboo == 0)).sum(), cnt.sum() // 2])


def _cnt_of(ell, colors: torch.Tensor) -> torch.Tensor:
    """[n_pad] int32 same-colour neighbours a vertex, over either ELL
    layout a row block at a time (at config 3 the whole [1M, 1280] gather
    would be 5.2 GB)."""
    out = torch.empty((ell.n_pad,), dtype=torch.int32, device=colors.device)
    for s, neigh in _row_blocks(ell):
        e = s + neigh.shape[0]
        nc = neighbor_colors(neigh, colors)
        out[s:e] = (nc == colors[s:e, None]).sum(1, dtype=torch.int32)
    return out


def _cnt_of_packed(adj: torch.Tensor, colors: torch.Tensor, *, params: MCMCParams,
                   node_mask: torch.Tensor) -> torch.Tensor:
    """``_cnt_of`` on a packed adjacency: cnt[i] = NC[i, c_i], one K1."""
    nc = neighbor_color_counts(adj, colors, params.n_colors, node_mask)
    return torch.where(node_mask, _at_color(nc, colors), 0)


def _frontier_update(graph, colors_next, cnt, ids, valid, rows, cur):
    """``cnt`` after the rows ``ids`` moved from ``cur`` to their colours
    in ``colors_next``, no other vertex having moved: each neighbour gains
    or loses the moved vertex, and the moved rows' own counts are taken
    afresh.  The neighbours' adds go through ``index_add_`` into one
    extra slot, which the padding ids fill and which is cut off."""
    nc_new = neighbor_colors(rows, colors_next)
    new_a = torch.where(valid, colors_next[ids.clamp(max=graph.n_pad - 1).to(torch.int64)],
                        cur)
    same_new = nc_new == new_a[:, None]
    delta = same_new.to(torch.int32) - (nc_new == cur[:, None]).to(torch.int32)
    cnt_next = scatter_drop(cnt, rows.reshape(-1), delta.reshape(-1), accumulate=True)
    return scatter_drop(cnt_next, ids, same_new.sum(1, dtype=torch.int32))


# ------------------------------ iterations ------------------------------


def _full_iteration(ell, colors, taboo, source, *, params: MCMCParams, block: int,
                    backend: str):
    """One synchronous full sweep: (star, taboo', conflict edges of the
    CURRENT colouring as a 0-dim tensor).  ``pallas``: K2 with the count
    fused in, one launch on the card; ``xla``: its plain version and a
    separate count."""
    unif = source.next(ell.n_pad)
    p_eff = _p_eff_of(colors, params, ell.n_nodes, ell.node_mask)
    # the chain core's sweeps take a chain axis: this is one chain
    args = (ell, params, block, colors[None], taboo[None], unif[None],
            None if p_eff is None else p_eff[None])
    if backend == "pallas":
        star, new_taboo, _, conf = _sweep_pallas_fused(*args)
    else:
        star, new_taboo, _ = _sweep(*args)
        conf = _conflict_edges(ell, colors[None])
    return star[0], new_taboo[0], conf[0]


def _active_iteration(graph, colors, taboo, cnt, source, *, cap: int, params: MCMCParams,
                      backend: str):
    """Resample the <= ``cap`` frontier vertices, apply the passive
    dynamics to the rest and keep ``cnt``.  ``graph``: an ``EllGraph``, a
    ``BucketedEll`` or ``PackedRows``.  Returns (colors, taboo, cnt, (frontier size,
    conflict edges) of the new state), the pair read to the host in the
    iteration's one read."""
    n_pad, n_colors, n = graph.n_pad, params.n_colors, graph.n_nodes
    node_mask = graph.node_mask
    dev = colors.device
    t_iter = params.taboo_iterations

    ids, valid = frontier_ids((cnt > 0) & (taboo == 0) & node_mask, cap)
    ids_l = ids.clamp(max=n_pad - 1).to(torch.int64)
    rows = _rows_of(graph, ids, valid)
    cur = torch.where(valid, colors[ids_l], n_colors)
    p_eff = _p_eff_of(colors, params, n, node_mask)
    unif = source.next(cap)
    # K2 looks the rows up in _lookup_colors: on a flat layout the real
    # vertices' colours (staged in shared memory where they fit)
    sweep = resample_sweep if backend == "pallas" else resample_sweep_plain
    chosen, _, new_taboo_a, _ = sweep(
        rows, _lookup_colors(graph, colors), cur, torch.zeros((cap,), dtype=torch.int32, device=dev), 0,
        unif, p_eff, params.epsilon, params, self_ids=ids,
    )
    chosen = torch.where(valid, chosen, cur)

    # ---- passive dynamics: at most one ε-flip of a vertex with no conflict
    p_per = (n_colors - 1) * params.epsilon
    eligible = (cnt <= 0) & (taboo == 0) & node_mask
    n_elig = eligible.sum(dtype=torch.float32)
    log_keep = torch.log1p(torch.full((), -min(p_per, 0.999999), dtype=torch.float32,
                                      device=dev))
    p_any = 1.0 - torch.exp(n_elig * log_keep)
    do_flip = source.next(1) < p_any
    # [1]-shaped: indexing by a 0-dim tensor would read it to the host
    fv = source.randint(1, n_pad).to(torch.int64)
    offs = source.randint(1, max(n_colors, 2), low=1)
    fv_ok = do_flip & eligible[fv]
    flip_at = fv_ok & (torch.arange(n_pad, device=dev) == fv)
    fv_cur = colors[fv]
    fv_new = (fv_cur + offs) % n_colors

    # taboo: the frontier takes K2's; a count above 0 goes down; the other
    # passive vertices drew "keep", which re-arms it; a flipped vertex 0
    taboo_next = torch.where(taboo > 0, taboo - 1, node_mask.to(torch.int32) * t_iter)
    taboo_next = scatter_drop(taboo_next, ids, new_taboo_a)
    taboo_next = torch.where(flip_at, 0, taboo_next)

    # cnt follows the frontier's moves, then the flip's (a passive vertex,
    # not in the frontier; with no flip its id is the dropped padding id)
    colors_mid = scatter_drop(colors, ids, chosen)
    cnt_mid = _frontier_update(graph, colors_mid, cnt, ids, valid, rows, cur)
    colors_next = torch.where(flip_at, fv_new, colors_mid)
    fv_id = torch.where(fv_ok, fv, n_pad).to(torch.int32)
    cnt_next = _frontier_update(graph, colors_next, cnt_mid, fv_id, fv_ok,
                                _rows_of(graph, fv_id, fv_ok),
                                torch.where(fv_ok, fv_cur, n_colors))

    n_active, conflicts = _stats(cnt_next, taboo_next).tolist()  # the one host read
    return colors_next, taboo_next, cnt_next, (n_active, conflicts)


def _tailcut_round(graph, colors, cnt, ordered, source, *, cap: int, params: MCMCParams):
    """One frontier-sized greedy round: conflicting vertices with a free
    colour and no lower-id such neighbour move to their first free colour
    in ``ordered`` order (colours by ascending class size, fixed at the
    tailcut's start); when the round can move nobody, the frontier takes
    the round's random colours (the stall escape).  Returns (colors,
    cnt)."""
    n_pad, n_colors = graph.n_pad, params.n_colors
    dev = colors.device
    ids, valid = frontier_ids((cnt > 0) & graph.node_mask, cap)
    rows = _rows_of(graph, ids, valid)
    cur = torch.where(valid, colors[ids.clamp(max=n_pad - 1).to(torch.int64)], n_colors)
    occ = occupancy_matrix(neighbor_colors(rows, colors), n_colors)  # [cap, nCol]
    free_perm = ~occ[:, ordered.to(torch.int64)]
    found = free_perm.any(1)
    # argmax returns the first of equal maxima, as jnp's
    cand = ordered[free_perm.to(torch.int32).argmax(1)]
    movable = scatter_drop(torch.zeros((n_pad,), dtype=torch.bool, device=dev), ids,
                           valid & found)
    movable_ext = torch.cat([movable, movable.new_zeros((1,))])
    nb_movable = movable_ext.index_select(0, rows.reshape(-1)).view(rows.shape)
    lower = (nb_movable & (rows < ids[:, None])).any(1)
    active = valid & found & ~lower
    stalled = ~active.any()
    rnd = source.randint(cap, n_colors)
    new_col = torch.where(active, cand, torch.where(stalled & valid, rnd, cur))
    colors_next = scatter_drop(colors, ids, new_col)
    return colors_next, _frontier_update(graph, colors_next, cnt, ids, valid, rows, cur)


def _tailcut_active(graph, colors, cnt, source, *, params: MCMCParams, caps: list[int]):
    """Frontier tailcut rounds until no conflict is left (at most n +
    1000 rounds), each over the conflicting vertices only: (colors, cnt,
    conflicts, rounds).  ``conflicts`` is the count read before the last
    round, as in JAX."""
    hist = color_histogram(colors, params.n_colors, graph.node_mask)
    ordered = torch.argsort(hist, stable=True).to(torch.int32)
    no_taboo = torch.zeros_like(cnt)
    rounds, conflicts = 0, None
    while rounds < graph.n_nodes + 1000:
        n_flag, conflicts = _stats(cnt, no_taboo).tolist()
        if conflicts == 0:
            break
        rounds += 1
        cap = pick_cap(caps, n_flag)
        with round_range("mcmc tailcut", cap):
            colors, cnt = _tailcut_round(graph, colors, cnt, ordered, source, cap=cap,
                                         params=params)
    return colors, cnt, conflicts, rounds


def _frontier_loop(graph, colors, taboo, cnt, stats, source, rip: int, trace: list, *,
                   params: MCMCParams, backend: str, caps: list[int]):
    """Frontier iterations from ``rip`` while the conflicts exceed the
    tailcut threshold and the cap allows, the statistics of the current
    state measured first (so a cap exit reports its final colouring's
    conflicts).  ``stats``: those of the entry state, or None to read
    them.  Returns (colors, taboo, cnt, rip, conflicts, iterations by
    cap)."""
    z = params.tailcut_threshold(graph.n_nodes)
    by_cap = Counter()
    if stats is None:
        stats = _stats(cnt, taboo).tolist()
    while True:
        n_active, conflicts = stats
        trace.append(conflicts)
        if conflicts <= z or rip >= params.max_iterations:
            break
        rip += 1
        cap = pick_cap(caps, n_active)
        with round_range("mcmc", cap):
            colors, taboo, cnt, stats = _active_iteration(
                graph, colors, taboo, cnt, source, cap=cap, params=params, backend=backend
            )
        by_cap[cap] += 1
    return colors, taboo, cnt, rip, conflicts, dict(sorted(by_cap.items()))


@dataclass
class FrontierChain:
    """Where ``ActiveMCMCColorer``'s chain ended, before the tailcut."""

    colors: torch.Tensor
    taboo: torch.Tensor
    cnt: torch.Tensor | None          # None if no frontier iteration was needed
    rip: int
    conflicts: int
    trace: list
    full_sweeps: int                  # full-iteration bodies, the last one included
    switch_iteration: int | None      # the iteration after which cnt was first kept
    frontier_iterations: dict         # cap -> frontier iterations at it


class ActiveMCMCColorer:
    """The frontier MCMC chain over a host ``Graph`` laid out as an ELL on
    ``device`` (counterpart of JAX's ``ActiveMCMCColorer``), flat or, with
    ``layout="bucketed"``, MCMCColorer's bucketed layout.

    ``backend``: ``pallas`` (K2 for the full sweeps and the frontier rows;
    on CPU tensors its plain version), ``xla`` (the plain versions, JAX's
    choice on the CPU) or ``auto`` (= ``pallas``).  The ladder's factor
    is 4 (``_buckets``).  Hastings is refused:
    the frontier never forms the passive vertices' proposal, so the
    acceptance ratio is undefined.  ``device``: the current CUDA device
    by default (``colorer_device``); the CPU only when asked for."""

    def __init__(
        self,
        graph: Graph,
        params: MCMCParams,
        backend: str = "auto",
        layout: str = "flat",
        device="cuda",
    ) -> None:
        if params.hastings:
            raise NotImplementedError(
                "active-set mode implements the shipped always-accept dynamics; "
                "use MCMCColorer (full sweeps) for Hastings"
            )
        if layout not in ("flat", "bucketed"):
            raise ValueError(f"unknown layout {layout!r}")
        if backend == "auto":
            backend = "pallas"
        if backend not in ("pallas", "xla"):
            raise ValueError(f"unknown backend {backend!r} for the frontier chain")
        self.graph, self.params, self.backend, self.layout = graph, params, backend, layout
        self.device = colorer_device(device)
        self.block = choose_block_size(graph.n, params.n_colors)
        t0 = time.perf_counter()
        self._perm = self._pos = None
        if layout == "bucketed":
            self.block = min(self.block, 2048)
            self.ell, self._perm, self._pos = bucketed_layout(
                graph, descending=False, min_lane=128 if backend == "pallas" else 8,
                device=self.device,
            )
        else:
            self.ell = graph.to_ell(
                pad_nodes_to=max(self.block, 128),
                pad_degree_to=degree_pad_for(graph, backend),
                device=self.device,
            )
        _sync(self.device)
        self.setup_seconds = time.perf_counter() - t0
        self._caps = _buckets(self.ell.n_pad)

    def _chain(self, source) -> FrontierChain:
        """Full sweeps until ``2·conflicts < n_pad // 8`` (the conflicts of
        the colouring each sweep starts from), then frontier iterations."""
        ell, params = self.ell, self.params
        z = params.tailcut_threshold(ell.n_nodes)
        colors = _init_colors(ell.n_pad, ell.n_nodes, params, source, self.device,
                              ell.node_mask)
        taboo = torch.zeros((ell.n_pad,), dtype=torch.int32, device=self.device)
        trace, rip, full_sweeps, conflicts, switch = [], 0, 0, None, None
        # full mode: each sweep measures the conflicts of the colouring it
        # starts from and its proposal is dropped once converged
        while rip < params.max_iterations:
            star, new_taboo, conf = _full_iteration(
                ell, colors, taboo, source, params=params, block=self.block,
                backend=self.backend,
            )
            full_sweeps += 1
            conflicts = int(conf)  # host read: the loop's exit test
            trace.append(conflicts)
            if conflicts <= z:
                break
            colors, taboo = star, new_taboo
            rip += 1
            if 2 * conflicts < ell.n_pad // 8:
                switch = rip
                break
        cnt, by_cap = None, {}
        if switch is not None:
            cnt = _cnt_of(ell, colors)
            colors, taboo, cnt, rip, conflicts, by_cap = _frontier_loop(
                ell, colors, taboo, cnt, None, source, rip, trace, params=params,
                backend=self.backend, caps=self._caps,
            )
        elif conflicts is None or conflicts > z:
            # the cap ended full mode: the final colouring's conflicts
            cnt = _cnt_of(ell, colors)
            conflicts = int(_stats(cnt, taboo)[1])
            trace.append(conflicts)
        return FrontierChain(colors, taboo, cnt, rip, conflicts, trace, full_sweeps, switch,
                             by_cap)

    def run(self, seed: int, repetition: int = 0, source=None) -> Coloring:
        """Colour the graph.  ``source`` (tests) replaces the run's uniform
        source (``utils/rng.py``)."""
        params, ell, dev = self.params, self.ell, self.device
        source = source or TorchUniformSource(seed, repetition, dev)
        _sync(dev)
        t0 = time.perf_counter()
        ch = self._chain(source)
        _sync(dev)
        chain_s = time.perf_counter() - t0
        colors, conflicts, tc_rounds = ch.colors, ch.conflicts, 0
        if params.tailcut and conflicts > 0:
            cnt = ch.cnt if ch.cnt is not None else _cnt_of(ell, colors)
            colors, _, conflicts, tc_rounds = _tailcut_active(
                ell, colors, cnt, source, params=params, caps=self._caps
            )
        out = colors_in_input_order(colors, self.graph.n, self._perm, self._pos)
        total_s = time.perf_counter() - t0
        return Coloring(
            colors=out,
            n_colors=params.n_colors,
            iterations=ch.rip,
            converged=conflicts <= params.tailcut_threshold(self.graph.n),
            duration_ms=total_s * 1e3,
            conflict_trace=np.asarray(ch.trace, dtype=np.int64),
            extra={
                "final_conflicts": conflicts,
                "max_iter_reached": ch.rip >= params.max_iterations,
                "tailcut_rounds": tc_rounds,
                "full_sweeps": ch.full_sweeps,
                "switch_iteration": ch.switch_iteration,
                "frontier_iterations": ch.frontier_iterations,
                "chain_seconds": chain_s,
                "tailcut_seconds": total_s - chain_s,
                "setup_seconds": self.setup_seconds,
            },
        )
