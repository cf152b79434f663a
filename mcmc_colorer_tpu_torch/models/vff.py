"""Vertex-centric First-Fit rebalancing colorer (VFF).

Counterpart of ``mcmc_colorer_tpu/models/vff.py``: phase 1
is GreedyFF; phase 2 moves the vertices of oversized colour classes
(more than gamma = n / used colours) into the lowest undersized class
that no neighbour uses, other than their own (kernel K3 with ``allow``
and ``cur`` on the card), keeps a mover flagged while a lower-id
neighbour shares its new colour, and stops when nothing is flagged.  A
10-round history of the flagged set detects a livelock, and then the
GreedyFF colouring is restored.  Integer work throughout, so the colours,
rounds and livelock flag equal JAX's exactly.

``active=True`` runs the frontier variant: phase 1 is the frontier
GreedyFF and each phase-2 round gathers only the flagged vertices' rows.
``layout="bucketed"`` runs both phases over GreedyFF's bucketed layout
(descending degrees); phase 2 calls K3 once a degree-class rectangle
with the whole palette, since ``allow`` may admit any colour.
"""

from __future__ import annotations

import time

import torch

from mcmc_colorer_tpu_torch.graph.container import Graph
from mcmc_colorer_tpu_torch.models.base import Coloring, colors_in_input_order
from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer, _gff_init, _gff_segment
from mcmc_colorer_tpu_torch.models.mcmc import _row_blocks, _sync
from mcmc_colorer_tpu_torch.models.mcmc_active import (
    DEFAULT_BUCKET_FACTOR,
    _buckets,
    pick_cap,
    round_range,
)
from mcmc_colorer_tpu_torch.ops.firstfit import first_fit, first_fit_plain
from mcmc_colorer_tpu_torch.ops.neighbor import (
    color_histogram,
    frontier_ids,
    neighbor_colors,
    scatter_drop,
    take_rows,
)
from mcmc_colorer_tpu_torch.utils.spans import span

_UNBALANCED_HISTORY = 10  # coloringVFF.cu:17


class VFFColorer:
    """``backend``: ``pallas`` (K3 on CUDA tensors), ``xla`` (K3's plain
    version everywhere) or ``auto`` (= ``pallas``).  ``layout``: ``flat``
    or ``bucketed``, GreedyFF's.  ``device``: the current CUDA device by
    default (``colorer_device``); the CPU only when asked for."""

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
        # phase 1's colorer builds the layout (and the relabelling) both
        # phases run on
        self._gff = GreedyFFColorer(
            graph, block_size=block_size, backend=backend, active=active,
            min_bucket=min_bucket, bucket_factor=bucket_factor, layout=layout, device=device,
        )
        self.graph, self.backend, self.active = graph, self._gff.backend, active
        self.device, self.ell = self._gff.device, self._gff.ell
        self.max_colors, self.block = self._gff.max_colors, self._gff.block
        self._min_bucket = min_bucket
        self._bucket_factor = bucket_factor or DEFAULT_BUCKET_FACTOR
        self.phase2_colors = None  # set by run()

    def _run_full(self):
        """(phase-2 colours, GreedyFF colours, used colours, rounds,
        livelock): both phases over every row, one host read a round."""
        ell, max_colors = self.ell, self.max_colors
        gff_colors, _, _ = _gff_segment(
            ell, _gff_init(ell), 2**30, max_colors=max_colors, block=self.block,
            backend=self.backend,
        )
        n_used, gamma, bins, unb, history = _phase2_start(ell, gff_colors, max_colors)
        palette = torch.arange(max_colors, device=self.device) < n_used
        colors, rounds, looping = gff_colors, 0, False
        flagged = bool(unb.any())  # host read, then one at the end of each round
        while flagged and not looping:
            with span("mc.vff.round"):
                # permissible targets: undersized bins within the used palette
                # (the reference scans i = 1..numColors only, coloringVFF.cu:381)
                allow = ((bins < gamma) & palette).to(torch.int32)
                colors = _tentative_rebalance(ell, colors, unb, allow, max_colors, self.backend)
                # solve_conflicts: stay flagged iff a lower-id neighbour shares
                # the new colour (coloringVFF.cu:411-437)
                unb = unb & _lower_id_conflicted(ell, colors)
                bins = color_histogram(colors, max_colors, ell.node_mask)
                with span("mc.vff.read"):
                    flagged = bool(unb.any())
                    looping = _push_history(history, rounds, unb)
                rounds += 1
        return colors, gff_colors, n_used, rounds, looping

    def _run_active(self):
        """The frontier variant, with ``_run_full``'s results."""
        ell = self.ell
        gff_colors, _ = self._gff._run_active()
        n_used, gamma, bins, unb, history = _phase2_start(ell, gff_colors, self.max_colors)
        n_unb = int(unb.sum())
        caps = _buckets(ell.n_pad, self._min_bucket, self._bucket_factor)
        colors, rounds, looping = gff_colors, 0, False
        while n_unb > 0 and not looping:
            cap = pick_cap(caps, n_unb)
            with round_range("vff", cap):
                colors, bins, unb, looping_t = _vff_active_round(
                    ell, colors, bins, unb, history, rounds, cap=cap,
                    max_colors=self.max_colors, n_used=n_used, gamma=gamma,
                    backend=self.backend,
                )
                n_unb = int(unb.sum())
                looping = bool(looping_t)
            rounds += 1
        return colors, gff_colors, n_used, rounds, looping

    def run(self, seed: int = 0, repetition: int = 0) -> Coloring:
        """Colour and rebalance (``seed`` and ``repetition`` are unused:
        the algorithm is deterministic).  ``self.phase2_colors`` keeps
        where phase 2 ended, which the livelock fallback discards."""
        _sync(self.device)
        t0 = time.perf_counter()
        with span("mc.run.vff"):
            run = self._run_active if self.active else self._run_full
            phase2, gff_colors, n_used, rounds, fell_back = run()
            # livelock: back to plain GreedyFF (coloringVFF.cu:232-234)
            perm, pos = self._gff._perm, self._gff._pos
            with span("mc.readback"):
                colors = colors_in_input_order(gff_colors if fell_back else phase2,
                                               self.graph.n, perm, pos)
        dur = (time.perf_counter() - t0) * 1e3
        self.phase2_colors = colors_in_input_order(phase2, self.graph.n, perm, pos)
        return Coloring(
            colors=colors,
            n_colors=int(n_used),
            iterations=int(rounds),
            converged=True,
            duration_ms=dur,
            extra={"livelock_fallback": bool(fell_back)},
        )


def _phase2_start(ell, gff_colors, max_colors: int):
    """(n_used, gamma, bins, flagged, history) at the start of phase 2:
    FF colours are dense from 0, so the used colours are the largest + 1;
    gamma = n / used colours; a vertex is flagged iff its class is
    oversized (detect_unbalanced_nodes, coloringVFF.cu:323-334)."""
    n_used = int(torch.where(ell.node_mask, gff_colors, -1).max()) + 1
    gamma = ell.n_nodes // max(n_used, 1)
    bins = color_histogram(gff_colors, max_colors, ell.node_mask)
    sz = bins[gff_colors.clamp(0, max_colors - 1).to(torch.int64)]
    history = torch.zeros((_UNBALANCED_HISTORY, ell.n_pad), dtype=torch.bool,
                          device=gff_colors.device)
    return n_used, gamma, bins, ell.node_mask & (gamma < sz), history


def _push_history(history, rounds: int, unb):
    """Write this round's flagged set into the 10-deep ring and return
    whether the ring is full and all its rows are equal (the livelock
    test of coloringVFF.cu:447-466).  The test does not depend on the
    rows' order, so the ring is written in place at ``rounds % 10``
    instead of being rolled."""
    history[rounds % _UNBALANCED_HISTORY] = unb
    filled = rounds + 1 >= _UNBALANCED_HISTORY
    return filled and bool((history == history[0:1]).all())


def _vff_active_round(ell, colors, bins, unb, history, rounds: int, *,
                      cap: int, max_colors: int, n_used: int, gamma: int,
                      backend: str = "pallas"):
    """One rebalancing round over the <= ``cap`` flagged vertices: each
    moves to its lowest free undersized class other than its own (K3 with
    ``allow`` and ``cur``), stays flagged iff a lower-id neighbour now
    shares its colour, and the bins follow the moves.  Returns (colours,
    bins, flagged, livelock)."""
    allow = ((bins < gamma) & (torch.arange(max_colors, device=bins.device) < n_used)).to(
        torch.int32)
    ids, valid = frontier_ids(unb, cap)
    rows = take_rows(ell, ids, valid)
    cur = torch.where(valid, colors[ids.clamp(max=ell.n_pad - 1).to(torch.int64)], max_colors)
    ff_fn = first_fit if backend == "pallas" else first_fit_plain
    # own colour forbidden (coloringVFF.cu:371-372)
    cand = ff_fn(rows, colors, allow, max_colors, cur)
    moved = valid & (cand >= 0)
    new_col = torch.where(moved, cand, cur)
    colors_next = scatter_drop(colors, ids, new_col)
    # conflicts can only pair two movers; a mover stays flagged iff a
    # lower-id neighbour now shares its colour
    nc_new = neighbor_colors(rows, colors_next)
    conflicted = ((nc_new == new_col[:, None]) & (rows < ids[:, None])).any(1)
    unb_next = scatter_drop(torch.zeros_like(unb), ids, valid & conflicted)
    # bins: -1 at the source class, +1 at the target (max_colors drops)
    bins = scatter_drop(bins, torch.where(moved, cur, max_colors), -1, accumulate=True)
    bins = scatter_drop(bins, torch.where(moved, new_col, max_colors), 1, accumulate=True)
    return colors_next, bins, unb_next, _push_history(history, rounds, unb_next)


def _tentative_rebalance(ell, colors, unb, allow, max_colors: int,
                         backend: str = "pallas"):
    """tentative_rebalancing over every row, a row block at a time (a band
    of the flat ELL or a degree-class rectangle): a flagged vertex moves
    to its lowest free allowed class other than its own (K3 with ``allow``
    and ``cur``; coloringVFF.cu:352-388).  The palette stays whole: the
    allowed classes need not be below the block's width."""
    ff_fn = first_fit if backend == "pallas" else first_fit_plain
    out = torch.empty_like(colors)
    for s, neigh in _row_blocks(ell):
        e = s + neigh.shape[0]
        cur = colors[s:e]
        cand = ff_fn(neigh, colors, allow, max_colors, cur)
        out[s:e] = torch.where(unb[s:e] & (cand >= 0), cand, cur)
    return out


def _lower_id_conflicted(ell, colors):
    """Per vertex: shares its colour with a lower-id neighbour."""
    ids = torch.arange(ell.n_pad, dtype=torch.int32, device=colors.device)
    out = torch.empty((ell.n_pad,), dtype=torch.bool, device=colors.device)
    for s, neigh in _row_blocks(ell):
        e = s + neigh.shape[0]
        nc = neighbor_colors(neigh, colors, fill=-2)
        out[s:e] = ((nc == colors[s:e, None]) & (neigh < ids[s:e, None])).any(1)
    return out
