"""Device-resident MCMC colorer for hash-defined G(n, p).

Counterpart of ``mcmc_colorer_tpu/models/mcmc_resident.py``: the device
builds the bit-packed adjacency of the hash graph itself
(``ops/hashgen.py``), the balance-dynamic chain runs against it
(``models/mcmc.py``), and what conflicts remain are repaired by the
NC-native independent-set tailcut (``_tailcut_nc_round``).  Every
neighbour interaction is NC = A·onehot(colors), kernel K1 on the card.

With ``active=True`` (``_run_active``) the chain runs full K1 sweeps in
budgets of 4 until ``2·conflicts < n_pad // 8``, tested between budgets,
then the frontier iterations of ``models/mcmc_active.py`` (K2 with
``self_ids``) on rows unpacked from A (``ops/dense_adj.packed_rows_to_ids``)
and ``cnt`` counted by K1, then the NC tailcut.

Ported: single-chain ``run``, full or frontier.  Ensembles (``n_chains >
1``), checkpoints and the free-colour TRACE raise ``NotImplementedError``;
ROADMAP.md Queue 1 item 11 (ensembles) and item 5 (checkpoints, trace)
port them.  As in JAX the frontier mode refuses ensembles, Hastings and
checkpoints.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind, default_n_colors
from mcmc_colorer_tpu_torch.models.base import Coloring, colorer_device
from mcmc_colorer_tpu_torch.models.mcmc import (
    _at_color,
    _chain_init,
    _chain_segment_matmul,
    _sync,
    choose_block_size,
)
from mcmc_colorer_tpu_torch.models.mcmc_active import (
    PackedRows,
    _buckets,
    _cnt_of_packed,
    _frontier_loop,
)
from mcmc_colorer_tpu_torch.ops.dense_adj import (
    PACKED_ADJ_MAX_N,
    RESIDENT_BUDGET_BYTES,
    n_col_pad_of,
    neighbor_color_counts,
    packed_adj_bytes,
    resident_bytes,
)
from mcmc_colorer_tpu_torch.ops.hashgen import (
    degrees_from_packed,
    er_packed_on_device_cached,
    er_threshold,
)
from mcmc_colorer_tpu_torch.utils.rng import TorchUniformSource


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def conflicts_from_packed(adj, colors, n_colors, node_mask) -> torch.Tensor:
    """Conflict-edge count via one NC: Σ_i NC[i, c_i] = 2 E_conf."""
    nc = neighbor_color_counts(adj, colors, n_colors, node_mask)
    return torch.where(node_mask, _at_color(nc, colors), 0).sum() // 2


def _pack_mask(mask: torch.Tensor, words: int) -> torch.Tensor:
    """[n_pad] bool -> [words] int32 (uint32 bit patterns) in the
    packed_bit_coords order."""
    k_total = words * 32
    m = torch.zeros((k_total,), dtype=torch.int64, device=mask.device)
    m[: mask.shape[0]] = mask.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)[None, :, None]
    v = (m.reshape(-1, 32, 128) << shifts).sum(1).reshape(words)  # < 2**32
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _any_neighbor_in(adj: torch.Tensor, bits: torch.Tensor, row_chunk: int = 8192):
    """[n_pad] bool: row i of A shares a set bit with ``bits``.  Equal to
    JAX's ``popcount(adj & bits).sum(1) > 0`` without a popcount; row
    bands keep the [rows, words] temporary small."""
    out = torch.empty((adj.shape[0],), dtype=torch.bool, device=adj.device)
    for r0 in range(0, adj.shape[0], row_chunk):
        blk = adj[r0:r0 + row_chunk]
        out[r0:r0 + blk.shape[0]] = ((blk & bits[None, :]) != 0).any(1)
    return out


def _tailcut_nc_round(adj, colors, coin_unif, node_mask, nc_prev=None, *, n_colors):
    """One independent-set repair round; returns (colors, conflicts,
    nc_new).  Conflicted vertices flip coins (``coin_unif < 0.5``); heads
    with no head neighbour move to their smallest NC-free colour (the
    least-occupied one if none is free).  ``nc_prev``, the previous
    round's exit NC of the same colouring, skips the entry NC."""
    words = adj.shape[1]
    nc = (
        nc_prev
        if nc_prev is not None
        else neighbor_color_counts(adj, colors, n_colors, node_mask)
    )
    n_col_pad = nc.shape[1]
    conflicted = (_at_color(nc, colors) > 0) & node_mask
    heads = conflicted & (coin_unif < 0.5)
    movers = heads & ~_any_neighbor_in(adj, _pack_mask(heads, words))
    col_ok = torch.arange(n_col_pad, device=nc.device)[None, :] < n_colors
    free = (nc == 0) & col_ok
    # argmax/argmin return the first index among ties, as jnp's do
    first_free = torch.argmax(free.to(torch.int32), dim=1).to(torch.int32)
    has_free = free.any(1)
    fallback = torch.argmin(torch.where(col_ok, nc, 2**30), dim=1).to(torch.int32)
    newc = torch.where(has_free, first_free, fallback)
    colors = torch.where(movers, newc, colors)
    nc_new = neighbor_color_counts(adj, colors, n_colors, node_mask)
    conflicts = torch.where(node_mask, _at_color(nc_new, colors), 0).sum() // 2
    return colors, conflicts, nc_new


class _StatsShim:
    """Graph-shaped stats carrier (n / n_edges / degrees / max_degree) for
    run logs; not an adjacency."""

    def __init__(self, n, n_edges, degrees, max_degree, name):
        self.n, self.n_edges = n, n_edges
        self.degrees, self.max_degree = degrees, max_degree
        self.name = name

    @property
    def mean_degree(self) -> float:
        return float(self.degrees.mean()) if self.n else 0.0


class ResidentMCMCColorer:
    """MCMC balanced colorer over a hash-defined G(n, p) that lives on
    ``device``: the current CUDA device by default (``colorer_device``),
    the CPU only when asked for.  ``params.n_colors <= 0`` means
    "palette = measured max degree / num_col_ratio"."""

    def __init__(
        self,
        n: int,
        p: float,
        graph_seed: int,
        params: MCMCParams | None = None,
        row_chunk: int = 2048,
        num_col_ratio: float = 1.0,
        n_chains: int = 1,
        active: bool = False,
        device="cuda",
    ) -> None:
        if active and n_chains > 1:
            raise NotImplementedError(
                "active resident mode is single-chain (the frontier's caps "
                "differ from chain to chain); use n_chains > 1 with full sweeps"
            )
        if active and params is not None and params.hastings:
            raise NotImplementedError(
                "active-set mode implements the shipped always-accept dynamics "
                "(see models/mcmc_active.py)"
            )
        if n_chains > 1:
            raise NotImplementedError(
                "resident ensembles (n_chains > 1) are not ported yet "
                "(ROADMAP.md Queue 1 item 11)"
            )
        self.device = colorer_device(device)
        self.n, self.p, self.graph_seed = n, p, graph_seed
        self.n_chains, self.active = n_chains, active
        n_pad = _round_up(n, row_chunk)
        if n_pad > PACKED_ADJ_MAX_N:
            raise ValueError(
                f"resident graphs are bound to the packed-adjacency HBM "
                f"cap: n_pad={n_pad} > {PACKED_ADJ_MAX_N} "
                f"({packed_adj_bytes(n_pad) / 1e9:.1f} GB of A bits)"
            )
        self.n_pad = n_pad
        t0 = time.perf_counter()
        self.adj = er_packed_on_device_cached(
            n, p, graph_seed, n_pad, row_chunk, device=self.device
        )
        degrees = degrees_from_packed(self.adj)
        self.max_degree = int(degrees.max())  # host read: waits for generation
        self.gen_seconds = time.perf_counter() - t0
        self.host_degrees = degrees[:n].cpu().numpy()
        self.n_edges = int(self.host_degrees.astype(np.int64).sum() // 2)
        if params is None or params.n_colors <= 0:
            n_col = default_n_colors(self.max_degree, num_col_ratio)
            if params is None:
                params = MCMCParams(
                    n_colors=n_col,
                    proposal=ProposalKind.BALANCE_DYNAMIC,
                    tailcut=True,
                )
            else:
                params = params.replace(n_colors=n_col)
        need = resident_bytes(n_pad, n_col_pad_of(params.n_colors))
        if self.device.type == "cuda" and need > RESIDENT_BUDGET_BYTES:
            raise ValueError(
                f"n_pad={n_pad} with {params.n_colors} colours needs "
                f"{need / 1e9:.1f} GB > {RESIDENT_BUDGET_BYTES / 1e9:.1f} GB"
            )
        self.params = params
        self.block = choose_block_size(n, params.n_colors)
        self.node_mask = torch.arange(n_pad, device=self.device) < n
        # the frontier's rows: every real row fits d_row ids
        self.d_row = _round_up(max(self.max_degree, 8), 8)

    @property
    def name(self) -> str:
        return f"er_hash_{self.n}_{self.p}"

    def stats_graph(self) -> _StatsShim:
        """Graph stats (n / m / degrees) without the adjacency."""
        return _StatsShim(
            self.n, self.n_edges, self.host_degrees, self.max_degree, self.name
        )

    def host_graph(self):
        """Host CSR of the same graph (threaded C++ hash enumeration), for
        validation; not needed to run."""
        from mcmc_colorer_tpu_torch.graph.native import generate_er_hash

        return generate_er_hash(
            self.n, er_threshold(self.p), self.graph_seed & 0xFFFFFFFF,
            name=self.name,
        )

    def _tailcut_nc(self, colors, conflicts: int, source):
        """NC tailcut rounds on a colouring with ``conflicts`` conflict
        edges, until none is left or 16 + 2·conflicts rounds: (colors,
        conflicts, rounds).  Each round draws its coins with
        ``next(n_pad)`` and hands its exit NC to the next."""
        rounds, max_rounds, nc_carry = 0, 16 + 2 * conflicts, None
        while conflicts > 0 and rounds < max_rounds:
            colors, conflicts_t, nc_carry = _tailcut_nc_round(
                self.adj, colors, source.next(self.n_pad), self.node_mask,
                nc_carry, n_colors=self.params.n_colors,
            )
            conflicts = int(conflicts_t)
            rounds += 1
        return colors, conflicts, rounds

    def _run_active(self, source) -> tuple:
        """The frontier chain (JAX ``_run_active``): phase 1 full K1 sweeps
        in budgets of 4, the switch tested between budgets on the last
        body's conflicts; phase 2 frontier iterations over ``PackedRows``.
        Returns (colors, rip, conflicts, trace, extra)."""
        params, n_pad = self.params, self.n_pad
        state = _chain_init(n_pad, self.n, params, source, self.device)
        while not state.done and state.rip < params.max_iterations:
            state = _chain_segment_matmul(
                self.adj, state, min(4, params.max_iterations - state.rip),
                params=params, block=self.block, n_nodes=self.n, source=source,
            )
            if not state.done and 2 * state.conf_last < n_pad // 8:
                break
        sweeps = int((state.trace >= 0).sum())
        switch = None if state.done or state.rip >= params.max_iterations else state.rip
        # drop unwritten slots (-1): a cap exit can leave one
        trace = [int(x) for x in state.trace[: state.rip + 1] if x >= 0]
        graph = PackedRows(self.adj, self.d_row, self.n, self.node_mask)
        cnt = _cnt_of_packed(self.adj, state.colors, params=params, node_mask=self.node_mask)
        colors, _, _, rip, conflicts, by_cap = _frontier_loop(
            graph, state.colors, state.taboo, cnt, None, source, state.rip, trace,
            params=params, backend="pallas", caps=_buckets(n_pad),
        )
        extra = {"active": True, "sweeps": sweeps, "switch_iteration": switch,
                 "frontier_iterations": by_cap}
        return colors, rip, conflicts, trace, extra

    def run(
        self,
        seed: int,
        repetition: int = 0,
        checkpoint_path: str | None = None,
        resume_from: str | None = None,
        source=None,
    ) -> Coloring:
        """Colour the graph.  ``source`` (tests) replaces the run's uniform
        source (``utils/rng.py``)."""
        if (checkpoint_path or resume_from) and self.active:
            raise NotImplementedError(
                "checkpointing covers the full-sweep resident runs; the "
                "active loop's cnt re-derives from colors"
            )
        if checkpoint_path or resume_from:
            raise NotImplementedError(
                "resident checkpoints are not ported yet (ROADMAP.md Queue 1 item 5)"
            )
        if os.environ.get("MCMC_COLORER_TRACE", "") not in ("", "0", "false"):
            raise NotImplementedError(
                "the free-colour TRACE is not ported yet (ROADMAP.md Queue 1 item 5)"
            )
        params, dev = self.params, self.device
        z = params.tailcut_threshold(self.n)
        source = source or TorchUniformSource(seed, repetition, dev)
        _sync(dev)
        t0 = time.perf_counter()
        if self.active:
            colors, rip, conflicts, trace, extra = self._run_active(source)
        else:
            state = _chain_init(self.n_pad, self.n, params, source, dev)
            state = _chain_segment_matmul(
                self.adj, state, params.max_iterations, params=params,
                block=self.block, n_nodes=self.n, source=source,
            )
            colors, rip = state.colors, state.rip
            trace = state.trace[: rip + 1]
            extra = {"sweeps": int((state.trace >= 0).sum())}  # body executions
            # a converged loop measured the final colouring in its last body;
            # a cap exit leaves conf_last describing the pre-swap colouring
            if state.done:
                conflicts = state.conf_last
            else:
                conflicts = int(
                    conflicts_from_packed(self.adj, colors, params.n_colors, self.node_mask)
                )
        _sync(dev)
        chain_s = time.perf_counter() - t0
        tc_rounds = 0
        if params.tailcut and conflicts > 0:
            colors, conflicts, tc_rounds = self._tailcut_nc(colors, conflicts, source)
        out = colors[: self.n].cpu().numpy()
        total_s = time.perf_counter() - t0
        return Coloring(
            colors=out,
            n_colors=params.n_colors,
            iterations=rip,
            converged=conflicts == 0 or conflicts <= z,
            duration_ms=total_s * 1e3,
            conflict_trace=np.asarray(trace, dtype=np.int64),
            extra={
                "final_conflicts": conflicts,
                "max_iter_reached": rip >= params.max_iterations,
                "tailcut_rounds": tc_rounds,
                "resident": True,
                "gen_seconds": self.gen_seconds,
                **extra,
                "chain_seconds": chain_s,
                # final conflict count, tailcut rounds and the colours' readback
                "tailcut_seconds": total_s - chain_s,
            },
        )
