"""Device-resident MCMC colorer for hash-defined G(n, p).

Counterpart of ``mcmc_colorer_tpu/models/mcmc_resident.py``: the device
builds the bit-packed adjacency of the hash graph itself
(``ops/hashgen.py``), the balance-dynamic chain runs against it
(``models/mcmc.py``), and what conflicts remain are repaired by the
NC-native independent-set tailcut (``_tailcut_nc``; where its rounds' cap
leaves conflicts in a chain that converged, a serial first-free pass,
``_finish_first_free``, a deliberate difference from JAX).  Every neighbour interaction is NC =
A·onehot(colors), kernel K1 on the card.

With ``active=True`` (``_run_active``) the chain runs full K1 sweeps in
budgets of 4 until ``2·conflicts < n_pad // 8``, tested between budgets,
then the frontier iterations of ``models/mcmc_active.py`` (K2 with
``self_ids``) on rows unpacked from A (``ops/dense_adj.packed_rows_to_ids``)
and ``cnt`` counted by K1, then the NC tailcut.

The full-sweep chain runs in segments (``utils/segmented.py``): at each
boundary it writes its checkpoint (``checkpoint_path``) and, under TRACE,
prints the free-colour line read from NC (JAX ``mcmc_resident.py:563-612``).
A checkpoint holds the chain state and the source's generator state, never
the graph: the graph re-derives from (n, p, graph_seed), which a load
checks.  One chain and an ensemble run the same chain core
(``models/mcmc.py``, ``_chains``): with ``n_chains > 1``, ``run`` is
``run_ensemble``, C chains over the one A, each sweep one K1 launch with
a chain axis, best of chains as ``parallel/chains.py``.  As in JAX the
frontier mode refuses ensembles, Hastings and checkpoints.
"""

from __future__ import annotations

import time
from functools import partial

import numpy as np
import torch

from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind, default_n_colors
from mcmc_colorer_tpu_torch.models.base import Coloring, colorer_device
from mcmc_colorer_tpu_torch.models.chain_api import (
    GENERATOR_KEY,
    npz_path,
    refuse_jax_checkpoint,
    save_npz_atomic,
)
from mcmc_colorer_tpu_torch.models.mcmc import (
    ChainState,
    _at_color,
    _chain_body,
    _chain_init,
    _chain_segment,
    _running,
    _sweep_matmul,
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
    er_packed_on_device_cached,
    hash_er_graph,
)
from mcmc_colorer_tpu_torch.utils.rng import ChainSources, TorchUniformSource
from mcmc_colorer_tpu_torch.utils.spans import span


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


ROW_CHUNK = 2048  # rows of the packed A a generation step writes


def packed_adj_fits(n: int, row_chunk: int = ROW_CHUNK) -> bool:
    """Whether G(n, p)'s packed adjacency fits the resident path's cap
    (``ops/dense_adj.PACKED_ADJ_MAX_N``)."""
    return _round_up(n, row_chunk) <= PACKED_ADJ_MAX_N


def conflicts_from_packed(adj, colors, n_colors, node_mask) -> torch.Tensor:
    """Conflict-edge count via one NC: Σ_i NC[i, c_i] = 2 E_conf; [C]
    counts, one K1 launch, for colours [C, n_pad]."""
    nc = neighbor_color_counts(adj, colors, n_colors, node_mask)
    return torch.where(node_mask, _at_color(nc, colors), 0).sum(-1) // 2


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


def _first_free(nc: torch.Tensor, n_colors: int) -> torch.Tensor:
    """[rows] int32: each row's smallest colour with NC 0, the least
    occupied one where none is (argmax/argmin take the first index among
    ties, as jnp's do)."""
    col_ok = torch.arange(nc.shape[-1], device=nc.device)[None, :] < n_colors
    free = (nc == 0) & col_ok
    first_free = torch.argmax(free.to(torch.int32), dim=1).to(torch.int32)
    fallback = torch.argmin(torch.where(col_ok, nc, 2**30), dim=1).to(torch.int32)
    return torch.where(free.any(1), first_free, fallback)


def _tailcut_nc_round(adj, colors, coin_unif, node_mask, nc_prev=None, running=None, *,
                      n_colors):
    """One independent-set repair round of C chains (colours and coins
    [C, n_pad]); returns (colors, conflicts [C], nc_new).  Conflicted
    vertices flip coins (``coin_unif < 0.5``); heads with no head
    neighbour move to their smallest NC-free colour (the least-occupied
    one if none is free).  Only the chains with ``running`` (a host mask;
    all by default) move.  ``nc_prev``, the previous round's exit NC of
    the same colourings, skips the entry NC; each NC is one K1 launch for
    all chains."""
    words = adj.shape[1]
    nc = (
        nc_prev
        if nc_prev is not None
        else neighbor_color_counts(adj, colors, n_colors, node_mask)
    )
    new = []
    for k in range(colors.shape[0]):
        if running is not None and not running[k]:
            new.append(colors[k])
            continue
        conflicted = (_at_color(nc[k], colors[k]) > 0) & node_mask
        heads = conflicted & (coin_unif[k] < 0.5)
        movers = heads & ~_any_neighbor_in(adj, _pack_mask(heads, words))
        new.append(torch.where(movers, _first_free(nc[k], n_colors), colors[k]))
    del nc  # the entry NC, unless the caller threads it
    colors = torch.stack(new)
    nc_new = neighbor_color_counts(adj, colors, n_colors, node_mask)
    conflicts = torch.where(node_mask, _at_color(nc_new, colors), 0).sum(1) // 2
    return colors, conflicts, nc_new


def _free_color_of_row(row: torch.Tensor, colors: torch.Tensor, n_colors: int,
                       own: int) -> int:
    """The colour a vertex takes in the serial first-free pass: its
    smallest colour that no neighbour holds (``row``, its [words] packed
    A row; ``colors``, every vertex's [n_pad]) where a neighbour holds
    ``own``, its colour, and some colour is free; else ``own``."""
    words = row.shape[0]
    shifts = torch.arange(32, dtype=torch.int32, device=row.device)[:, None]
    # the neighbours in column order (ops/dense_adj.packed_bit_coords)
    bits = (row.view(words // 128, 1, 128) >> shifts) & 1
    held = torch.zeros((n_colors + 1,), dtype=torch.bool, device=row.device)
    held[colors[torch.nonzero(bits.flatten()).flatten()].clamp(0, n_colors)] = True
    if bool(held[min(max(own, 0), n_colors)]) and not bool(held[:n_colors].all()):
        return int(torch.argmin(held[:n_colors].to(torch.int32)))
    return own


def _finish_first_free(adj, colors, conflicts, node_mask, *, n_colors: int):
    """What the rounds' cap left: in each chain with conflicts, every
    vertex still in a conflict, one at a time in id order, takes its
    smallest colour that no neighbour holds, or keeps its own where every
    colour is held (``_free_color_of_row``; the reference CUDA program's
    serial tailcut epilogue, ``coloringMCMC_utils.cu:tailCutting``).  One
    at a time, no two movers meet, so each move ends its vertex's
    conflicts.  JAX stops at the cap with the conflicts
    (``mcmc_resident.py:491``).  The rounds end there where the two ends
    of a conflict flip the same coin round after round: at ER(100k,
    0.01), nCol = max degree, one job in 6,200 on an H100, its two
    conflicted vertices with hundreds of free colours
    (``scripts/tailcut_cap_repro.py``).  The mesh's strip tailcut ends the
    same way (``parallel/sharded.py``).  Returns (colours, conflicts
    [C])."""
    colors = colors.clone()
    nc = neighbor_color_counts(adj, colors, n_colors, node_mask)
    for k in np.flatnonzero(conflicts > 0):
        bad = torch.nonzero((_at_color(nc[k], colors[k]) > 0) & node_mask).flatten().tolist()
        for v in bad:
            colors[k, v] = _free_color_of_row(adj[v], colors[k], n_colors, int(colors[k, v]))
    return colors, np.where(conflicts > 0, conflicts_from_packed(
        adj, colors, n_colors, node_mask).cpu().numpy(), conflicts)


def _tailcut_nc(adj, colors, conflicts, sources, node_mask, *, n_colors: int,
                thread_nc: bool, z: int):
    """NC tailcut rounds of C chains: a chain runs while it has conflicts
    and fewer than its own 16 + 2·conflicts rounds, as a run of it alone
    would; only running chains draw their coins (``next(n_pad)`` a round).
    ``thread_nc`` hands each round's exit NC to the next, as JAX's single
    chain does; JAX's ensemble threads none (``mcmc_resident.py:728-735``),
    and pays a second K1 launch a round.  A chain whose chain converged
    (it came in with at most ``z`` conflicts, the tailcut threshold) and
    that reaches its cap with conflicts is finished by
    ``_finish_first_free``; one that came in with more ends at its cap
    with its conflicts, as in JAX.  Returns (colours, conflicts [C],
    rounds [C])."""
    conflicts = np.asarray(conflicts).copy()
    cap = 16 + 2 * conflicts
    converged = conflicts <= z
    rounds = np.zeros(len(conflicts), np.int64)
    nc = None
    with span("mc.tailcut"):
        while True:
            running = (conflicts > 0) & (rounds < cap)
            if not running.any():
                left = np.where(converged, conflicts, 0)
                if left.any():
                    colors, done = _finish_first_free(adj, colors, left, node_mask,
                                                      n_colors=n_colors)
                    conflicts = np.where(converged, done, conflicts)
                return colors, conflicts, rounds
            with span("mc.tailcut.round"):
                colors, fresh, nc = _tailcut_nc_round(
                    adj, colors, sources.next(colors.shape[1], running), node_mask, nc, running,
                    n_colors=n_colors)
                if not thread_nc:
                    nc = None
                with span("mc.tailcut.read"):
                    conflicts = np.where(running, fresh.cpu().numpy(), conflicts)
            rounds += running


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
        row_chunk: int = ROW_CHUNK,
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
        self.device = colorer_device(device)
        self.n, self.p, self.graph_seed = n, p, graph_seed
        self.n_chains, self.active = n_chains, active
        n_pad = _round_up(n, row_chunk)
        if not packed_adj_fits(n, row_chunk):
            raise ValueError(
                f"resident graphs are bound to the packed-adjacency HBM "
                f"cap: n_pad={n_pad} > {PACKED_ADJ_MAX_N} "
                f"({packed_adj_bytes(n_pad) / 1e9:.1f} GB of A bits); for larger "
                f"graphs run MCMCColorer over graph.container.HashGraph(n, p, "
                f"graph_seed), the flat ELL built on the device (CLI: --resident "
                f"--backend pallas)"
            )
        self.n_pad = n_pad
        t0 = time.perf_counter()
        with span("mc.hashgen"):
            self.adj, degrees = er_packed_on_device_cached(
                n, p, graph_seed, n_pad, row_chunk, device=self.device
            )
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
        return hash_er_graph(self.n, self.p, self.graph_seed, name=self.name)

    # ---- checkpoints: the chain state, never the graph (JAX :348-402) ----

    def save_checkpoint(self, state: ChainState, path: str, sources) -> None:
        """``state``: the carry of C chains; ``sources`` their
        ``ChainSources``, whose generator states are stored.  One chain's
        checkpoint holds JAX's single-chain shapes ([n_pad] colours, scalar
        iteration); an ensemble's has a leading chain axis on every array.
        Written to a temporary file and renamed into place."""
        gen = np.stack([g.numpy() for g in sources.get_state()])
        one = state.colors.shape[0] == 1
        squeeze = (lambda x: x[0]) if one else (lambda x: x)  # noqa: E731
        save_npz_atomic(
            path,
            colors=squeeze(state.colors.cpu().numpy()),
            taboo=squeeze(state.taboo.cpu().numpy()),
            **{GENERATOR_KEY: squeeze(gen)},
            iteration=squeeze(state.rip),
            conf_last=squeeze(state.conf_last),
            trace=squeeze(state.trace),
            done=squeeze(state.done),
            n=self.n,
            p=self.p,
            graph_seed=self.graph_seed,
            n_colors=self.params.n_colors,
        )

    def load_checkpoint(self, path: str):
        """(carry, generator states): the carry of the checkpoint's chains
        (one, or an ensemble's) and a generator state a chain.  The graph
        spec and the palette must match; the trace is padded (with -1,
        unwritten) or cut to ``max_iterations + 1``."""
        path = npz_path(path)
        d = np.load(path)
        refuse_jax_checkpoint(d, path)
        spec = (int(d["n"]), float(d["p"]), int(d["graph_seed"]))
        if spec != (self.n, float(self.p), self.graph_seed):
            raise AssertionError(
                f"resident graph spec mismatch: checkpoint {spec} vs colorer "
                f"{(self.n, float(self.p), self.graph_seed)}"
            )
        if int(d["n_colors"]) != self.params.n_colors:
            raise AssertionError("palette mismatch")
        one = d["colors"].ndim == 1
        axis = (lambda x: np.asarray(x)[None]) if one else np.asarray  # noqa: E731
        width = self.params.max_iterations + 1
        trace = axis(d["trace"]).astype(np.int32)[:, :width]
        if trace.shape[1] < width:
            trace = np.pad(trace, [(0, 0), (0, width - trace.shape[1])], constant_values=-1)
        state = ChainState(
            torch.from_numpy(axis(d["colors"]).copy()).to(self.device),
            torch.from_numpy(axis(d["taboo"]).copy()).to(self.device),
            axis(d["iteration"]).astype(np.int64), axis(d["conf_last"]).astype(np.int64),
            trace, axis(d["done"]).astype(bool),
        )
        # set_state reads a whole storage: one fresh tensor a chain
        return state, [torch.from_numpy(g.copy()) for g in axis(d[GENERATOR_KEY])]

    def free_color_stats(self, colors) -> tuple[int, int, float]:
        """(min, max, avg) free colours of one chain's real vertices, read
        from NC: free[i] = #{c < nCol : NC[i, c] = 0} (JAX ``_free_nc``);
        one K1 launch and one host read."""
        n_colors = self.params.n_colors
        nc = neighbor_color_counts(self.adj, colors, n_colors, self.node_mask)
        col_ok = torch.arange(nc.shape[1], device=nc.device) < n_colors
        free = ((nc == 0) & col_ok[None, :]).sum(1)
        mask = self.node_mask
        lo, hi, tot = torch.stack([torch.where(mask, free, n_colors + 1).min(),
                                   torch.where(mask, free, -1).max(),
                                   torch.where(mask, free, 0).sum()]).tolist()
        return lo, hi, tot / max(self.n, 1)

    def _segment(self, sources):
        """(segment function, progress function) of the full-sweep chain of
        C = ``len(sources)`` chains over A: do-while bodies, one K1 launch
        each for all chains."""
        params, n = self.params, self.n
        body = partial(_chain_body, params=params, block=self.block, n_nodes=n,
                       sources=sources, sweep=_sweep_matmul)
        cap = np.full(len(sources), params.max_iterations)

        def segment(st, budget):
            return _chain_segment(self.adj, st, budget, params=params, n_nodes=n, fused=True,
                                  body=body)

        def progress(st):
            return st.bodies, not _running(st, cap, params=params, n_nodes=n, fused=True).any()

        return segment, progress

    def _chains(self, sources, checkpoint_path, resume_from, *, trace: bool, thread_nc: bool):
        """The full-sweep chain of C = ``len(sources)`` chains from a fresh
        start or ``resume_from``, in segments, each ending with a
        checkpoint where ``checkpoint_path`` is given and, with ``trace``,
        chain 0's free-colour line; then the final counts (one K1 launch,
        only where a chain stopped at the cap) and the NC tailcut.  Returns
        (carry, colours, conflicts [C], tailcut rounds [C], free-colour
        segments, chain seconds, start time)."""
        from mcmc_colorer_tpu_torch.models.mcmc import trace_free_colors
        from mcmc_colorer_tpu_torch.utils.segmented import drive_segments

        params, dev = self.params, self.device
        fc_segments: list = []

        def on_segment(st, *_):
            if trace:
                fc_segments.append(self.free_color_stats(st.colors[0]))
                trace_free_colors(fc_segments[-1])
            if checkpoint_path:
                self.save_checkpoint(st, checkpoint_path, sources)

        _sync(dev)
        t0 = time.perf_counter()
        with span("mc.chain"):
            if resume_from:
                state, gen = self.load_checkpoint(resume_from)
                if state.colors.shape[0] != len(sources):
                    raise AssertionError("checkpoint chain count mismatch")
                sources.set_state(gen)
            else:
                state = _chain_init(self.n_pad, self.n, params, sources, dev)
            segment, progress = self._segment(sources)
            state = drive_segments(segment, state, progress, on_segment=on_segment)
            # a converged chain measured its final colouring in its last body;
            # a cap exit leaves conf_last describing the pre-swap colouring
            conflicts = state.conf_last.copy()
            if not state.done.all():
                fresh = conflicts_from_packed(self.adj, state.colors, params.n_colors,
                                              self.node_mask)
                conflicts = np.where(state.done, conflicts, fresh.cpu().numpy())
            _sync(dev)
        chain_s = time.perf_counter() - t0
        colors, rounds = state.colors, np.zeros(len(sources), np.int64)
        if params.tailcut and conflicts.max() > 0:
            colors, conflicts, rounds = _tailcut_nc(
                self.adj, colors, conflicts, sources, self.node_mask,
                n_colors=params.n_colors, thread_nc=thread_nc,
                z=params.tailcut_threshold(self.n))
        return state, colors, conflicts, rounds, fc_segments, chain_s, t0

    def _run_active(self, source) -> tuple:
        """The frontier chain (JAX ``_run_active``): phase 1 full K1 sweeps
        in budgets of 4, the switch tested between budgets on the last
        body's conflicts; phase 2 frontier iterations over ``PackedRows``.
        Returns (colors, rip, conflicts, trace, extra)."""
        params, n_pad = self.params, self.n_pad
        sources = ChainSources([source], self.device)
        state = _chain_init(n_pad, self.n, params, sources, self.device)
        segment, _ = self._segment(sources)
        while not state.done[0] and state.rip[0] < params.max_iterations:
            state = segment(state, 4)
            if not state.done[0] and 2 * state.conf_last[0] < n_pad // 8:
                break
        rip0 = int(state.rip[0])
        sweeps = state.bodies
        switch = None if state.done[0] or rip0 >= params.max_iterations else rip0
        # drop unwritten slots (-1): a cap exit can leave one
        trace = [int(x) for x in state.trace[0, : rip0 + 1] if x >= 0]
        graph = PackedRows(self.adj, self.d_row, self.n, self.node_mask)
        colors, taboo = state.colors[0], state.taboo[0]
        cnt = _cnt_of_packed(self.adj, colors, params=params, node_mask=self.node_mask)
        colors, _, _, rip, conflicts, by_cap = _frontier_loop(
            graph, colors, taboo, cnt, None, source, rip0, trace,
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
        source (``utils/rng.py``).  The full-sweep chain writes a checkpoint
        at each segment boundary where ``checkpoint_path`` is given, and
        resumes from ``resume_from``; under TRACE it prints each segment's
        free-colour line and records it in
        ``extra["free_color_trace_segments"]``.  With ``n_chains > 1`` this
        is ``run_ensemble``'s best chain (its summaries in
        ``last_summaries``)."""
        with span("mc.run.resident"):
            return self._run(seed, repetition, checkpoint_path, resume_from, source)

    def _run(self, seed, repetition, checkpoint_path, resume_from, source) -> Coloring:
        from mcmc_colorer_tpu_torch.utils import term

        if (checkpoint_path or resume_from) and self.active:
            raise NotImplementedError(
                "checkpointing covers the full-sweep resident runs; the "
                "active loop's cnt re-derives from colors"
            )
        if self.n_chains > 1:
            best, self.last_summaries = self.run_ensemble(
                seed, repetition, checkpoint_path=checkpoint_path, resume_from=resume_from)
            return best
        params, dev = self.params, self.device
        source = source or TorchUniformSource(seed, repetition, dev)
        fc_segments: list = []
        if self.active:
            _sync(dev)
            t0 = time.perf_counter()
            with span("mc.chain"):
                colors, rip, conflicts, trace, extra = self._run_active(source)
                _sync(dev)
            chain_s = time.perf_counter() - t0
            tc_rounds = 0
            if params.tailcut and conflicts > 0:
                out, conf, tc = _tailcut_nc(
                    self.adj, colors[None], np.array([conflicts]), ChainSources([source], dev),
                    self.node_mask, n_colors=params.n_colors, thread_nc=True,
                    z=params.tailcut_threshold(self.n))
                colors, conflicts, tc_rounds = out[0], int(conf[0]), int(tc[0])
        else:
            state, colors, conf, tc, fc_segments, chain_s, t0 = self._chains(
                ChainSources([source], dev), checkpoint_path, resume_from,
                trace=term.trace_enabled(), thread_nc=True)
            rip, conflicts, tc_rounds = int(state.rip[0]), int(conf[0]), int(tc[0])
            colors, trace = colors[0], state.trace[0, : rip + 1]
            extra = {"sweeps": state.bodies}  # body executions
        with span("mc.readback"):
            out = colors[: self.n].cpu().numpy()
        total_s = time.perf_counter() - t0
        return Coloring(
            colors=out,
            n_colors=params.n_colors,
            iterations=rip,
            converged=conflicts == 0 or conflicts <= params.tailcut_threshold(self.n),
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
                **({"free_color_trace_segments": fc_segments} if fc_segments else {}),
            },
        )

    def run_ensemble(self, seed: int, repetition: int = 0,
                     checkpoint_path: str | None = None, resume_from: str | None = None,
                     sources=None):
        """``n_chains`` independent chains over the one resident A, each
        sweep one K1 launch with a chain axis; returns (best Coloring,
        summaries), best of chains as ``parallel/chains.py`` (fewest
        conflicts, then the smallest class-size std).  Checkpoints as
        ``run``'s, with a leading chain axis.  The tailcut threads no NC
        between rounds (JAX :728-735).  ``sources`` (tests) replaces the
        chains' sources (``utils/rng.ChainSources``)."""
        from mcmc_colorer_tpu_torch.parallel.chains import class_stds, pick_best

        params, n = self.params, self.n
        sources = sources or ChainSources.seeded(seed, repetition, self.n_chains, self.device)
        state, colors, conflicts, rounds, _, _, t0 = self._chains(
            sources, checkpoint_path, resume_from, trace=False, thread_nc=False)
        with span("mc.readback"):
            out = colors[:, :n].cpu().numpy()
        rips = state.rip
        best, summaries = pick_best(class_stds(out, params.n_colors), conflicts, rips)
        return Coloring(
            colors=out[best],
            n_colors=params.n_colors,
            iterations=int(rips[best]),
            converged=int(conflicts[best]) <= params.tailcut_threshold(n),
            duration_ms=(time.perf_counter() - t0) * 1e3,
            conflict_trace=state.trace[best, : int(rips[best]) + 1].astype(np.int64),
            extra={
                "final_conflicts": int(conflicts[best]),
                "max_iter_reached": bool(rips[best] >= params.max_iterations),
                "tailcut_rounds": int(rounds.max()),
                "resident": True,
                "gen_seconds": self.gen_seconds,
                "best_chain": best,
                "chains": self.n_chains,
                "sweeps": state.bodies,  # batched bodies, one K1 launch each
            },
        ), summaries
