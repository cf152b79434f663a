"""Greedy First-Fit (speculative) colorer.

Counterpart of ``mcmc_colorer_tpu/models/greedy_ff.py``: repeat { every
uncoloured vertex takes its smallest colour no neighbour uses (kernel K3
on the card); of two same-coloured neighbours the higher id loses and is
uncoloured again } until every vertex holds a colour.  Colours are
0-based, -1 = uncoloured; the palette bound is max degree + 1, which
always leaves a free colour.  Deterministic, so its colours equal JAX's
exactly.

``active=True`` runs the frontier variant: each round first-fits only
the rows of the still-uncoloured vertices (``take_rows``), with K3's
palette cut to the row width + 1.  Same rules, so the same colours and
rounds as the full loop.  ``layout="bucketed"`` relabels the graph by
descending degree (the Welsh-Powell order: hubs win the lower-id rule)
and first-fits each degree-class rectangle with K3 at the palette
``min(max degree + 1, d_b + 1)``: a vertex's first free colour is at
most its degree, and K3 ignores a neighbour's colour outside the
palette, as JAX's occupancy drops it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mcmc_colorer_tpu_torch.graph.container import Graph, degree_pad_for
from mcmc_colorer_tpu_torch.models.base import (
    Coloring,
    bucketed_layout,
    colorer_device,
    colors_in_input_order,
)
from mcmc_colorer_tpu_torch.models.mcmc import _row_blocks, _sync, choose_block_size
from mcmc_colorer_tpu_torch.models.mcmc_active import (
    DEFAULT_BUCKET_FACTOR,
    _buckets,
    pick_cap,
    round_range,
)
from mcmc_colorer_tpu_torch.ops.firstfit import first_fit, first_fit_plain
from mcmc_colorer_tpu_torch.ops.neighbor import (
    frontier_ids,
    neighbor_colors,
    scatter_drop,
    take_rows,
)
from mcmc_colorer_tpu_torch.utils.spans import span


class GreedyFFColorer:
    """``backend``: ``pallas`` (K3 on CUDA tensors), ``xla`` (K3's plain
    version everywhere) or ``auto`` (= ``pallas``).  ``device``: the
    current CUDA device by default (``colorer_device``); the CPU only
    when asked for."""

    def __init__(
        self,
        graph: Graph,
        block_size: int | None = None,
        backend: str = "auto",
        active: bool = False,
        min_bucket: int = 128,
        bucket_factor: int | None = None,
        layout: str = "flat",
        device="cuda",
    ) -> None:
        if layout not in ("flat", "bucketed"):
            raise ValueError(f"unknown layout {layout!r}")
        if backend == "auto":
            backend = "pallas"
        if backend not in ("pallas", "xla"):
            raise ValueError(f"unknown backend {backend!r}")
        self.graph = graph
        self.backend = backend
        self.device = colorer_device(device)
        self.max_colors = graph.max_degree + 1
        self.block = block_size or choose_block_size(graph.n, self.max_colors)
        self.active = active
        self.layout = layout
        self._perm = self._pos = None
        if layout == "bucketed":
            if block_size is None:
                self.block = min(self.block, 2048)
            self.ell, self._perm, self._pos = bucketed_layout(
                graph, descending=True, min_lane=128 if backend == "pallas" else 8,
                device=self.device,
            )
        else:
            self.ell = graph.to_ell(
                pad_nodes_to=max(self.block, 128),
                pad_degree_to=degree_pad_for(graph, backend),
                device=self.device,
            )
        self._min_bucket = min_bucket
        self._bucket_factor = bucket_factor or DEFAULT_BUCKET_FACTOR

    def _run_active(self):
        """Host-driven frontier loop: (colours, rounds).  Each round reads
        the count of conflict losers on the host to size the next one."""
        ell = self.ell
        caps = _buckets(ell.n_pad, self._min_bucket, self._bucket_factor)
        colors = torch.where(ell.node_mask, -1, self.max_colors).to(torch.int32)
        uncolored, rounds = self.graph.n, 0
        while uncolored > 0:
            cap = pick_cap(caps, uncolored)
            with round_range("gff", cap):
                colors, n_unc = _gff_active_round(
                    ell, colors, cap=cap, max_colors=self.max_colors, backend=self.backend,
                )
                uncolored = int(n_unc)
            rounds += 1
        return colors, rounds

    def run(self, seed: int = 0, repetition: int = 0) -> Coloring:
        """Colour the graph (``seed`` and ``repetition`` are unused: the
        algorithm is deterministic; they keep the colorer interface)."""
        _sync(self.device)
        t0 = time.perf_counter()
        with span("mc.run.greedy_ff"):
            if self.active:
                colors, rounds = self._run_active()
            else:
                colors, rounds, _ = _gff_segment(
                    self.ell, _gff_init(self.ell), 2**30,
                    max_colors=self.max_colors, block=self.block, backend=self.backend,
                )
            with span("mc.readback"):
                colors = colors_in_input_order(colors, self.graph.n, self._perm, self._pos)
        dur = (time.perf_counter() - t0) * 1e3
        return Coloring(
            colors=colors,
            n_colors=int(np.unique(colors).shape[0]),  # distinct used colours
            iterations=rounds,
            converged=True,
            duration_ms=dur,
            extra={"palette_bound": self.max_colors},
        )


def _first_fit_pass(ell, colors, max_colors: int, block: int,
                    backend: str = "pallas"):
    """tentative_coloring: uncoloured vertices take their smallest colour
    no neighbour uses, a row block at a time (one K3 launch a band of the
    flat ELL or a degree-class rectangle, which gathers the neighbours'
    colours itself).  A vertex's first free colour is at most its degree,
    so a block of width d_b needs the palette d_b + 1 only (on the flat
    ELL that is max_colors: d_pad >= the max degree)."""
    ff_fn = first_fit if backend == "pallas" else first_fit_plain
    out = torch.empty_like(colors)
    for s, neigh in _row_blocks(ell):
        e = s + neigh.shape[0]
        pal = min(max_colors, neigh.shape[1] + 1)
        allow = torch.ones((pal,), dtype=torch.int32, device=colors.device)
        ff = ff_fn(neigh, colors, allow, pal)
        # a palette of degree + 1 leaves a free colour for every real vertex
        out[s:e] = torch.where(colors[s:e] < 0, ff, colors[s:e])
    return out


def _conflict_losers(ell, colors):
    """conflict_detection: a coloured vertex with the colour of a lower-id
    neighbour loses."""
    ids = torch.arange(ell.n_pad, dtype=torch.int32, device=colors.device)
    out = torch.empty((ell.n_pad,), dtype=torch.bool, device=colors.device)
    for s, neigh in _row_blocks(ell):
        e = s + neigh.shape[0]
        own = colors[s:e, None]
        nc = neighbor_colors(neigh, colors, fill=-2)
        out[s:e] = ((nc == own) & (own >= 0) & (neigh < ids[s:e, None])).any(1)
    return out


def _gff_active_round(ell, colors, *, cap: int, max_colors: int,
                      backend: str = "pallas"):
    """One frontier round over the <= ``cap`` uncoloured vertices: first
    fit on their gathered rows (K3 on the card), then the conflicts among
    the frontier only (a neighbour coloured earlier was occupied at first
    fit), the higher id losing.  Returns (colours, number of losers)."""
    ids, valid = frontier_ids((colors < 0) & ell.node_mask, cap)
    rows = take_rows(ell, ids, valid)
    # a first-fit colour is <= the degree <= the row width, so the
    # palette is cut to d_pad + 1
    pal = min(max_colors, rows.shape[1] + 1)
    ff_fn = first_fit if backend == "pallas" else first_fit_plain
    allow = torch.ones((pal,), dtype=torch.int32, device=colors.device)
    tentative = torch.where(valid, ff_fn(rows, colors, allow, pal), max_colors)
    colors_t = scatter_drop(colors, ids, tentative)
    nc_new = neighbor_colors(rows, colors_t)
    losers = valid & ((nc_new == tentative[:, None]) & (rows < ids[:, None])).any(1)
    final = torch.where(losers, -1, tentative)
    return scatter_drop(colors, ids, final), losers.sum()


def _gff_init(ell):
    """Initial carry (colors, rounds, done): real vertices uncoloured,
    phantoms colour 0."""
    colors0 = torch.where(ell.node_mask, -1, 0).to(torch.int32)
    return colors0, 0, ell.n_nodes == 0


def _gff_segment(ell, carry, budget: int, *, max_colors: int,
                 block: int, backend: str = "pallas"):
    """At most ``budget`` speculative rounds, each in the span
    ``mc.greedy.round`` with its host read in ``mc.greedy.read``."""
    colors, rounds, done = carry
    limit = rounds + budget
    while not done and rounds < limit:
        with span("mc.greedy.round"):
            tentative = _first_fit_pass(ell, colors, max_colors, block, backend)
            losers = _conflict_losers(ell, tentative)
            colors = torch.where(losers, -1, tentative)
            rounds += 1
            with span("mc.greedy.read"):
                done = not bool(((colors < 0) & ell.node_mask).any())  # host read
    return colors, rounds, done
