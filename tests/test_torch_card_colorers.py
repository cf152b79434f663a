"""The port's colourers on the card, one parametrised test over their paths.

Each case colours its graph on the card through the library surface
(every colourer runs on the current card by default), requires each
colouring valid against the graph (``check_coloring``, 0 final
conflicts), counts the kernel launches the path must make, and holds the
equalities between paths that must agree:

- the resident chain (K6 once for its graph, K1 and K4 a sweep) and a
  tight palette that needs the tailcut; the ELL chain (K2 a sweep), the
  packed chain over a host graph (its A equal to the resident A),
  Hastings over K2 and over K1, and the plain route;
- GreedyFF's frontier loop equal to its full loop; VFF full and frontier,
  each with K3 and with its plain version, equal (colours, rounds, the
  livelock flag and phase 2's colours), and K3 exact at VFF's two call
  sites on the run's own ``allow`` and ``cur``; resident Luby (K1) equal
  to the gather loop on the same draws;
- the frontier chains (a frontier iteration reads the host once, a
  tailcut round never; the kept cnt a recount), the resident frontier's
  rows unpacked from A equal to the host ELL's;
- config 4 (BA(50k, 8) through the network-repository converters) with
  every colourer flat and degree-bucketed, K2 a degree class a sweep;
- stepped chains, checkpoints, the debugger and the TRACE; ensembles,
  each chain equal to a one-chain run, and their batched K1, K2, K3 and
  K4 launches equal to one launch a chain; a chain body of one chain
  reads the host once;
- the sharded colourer on a 1x1 mesh under a one-rank NCCL group (a
  segmented and a resumed run bit-equal to an uninterrupted one), on the
  hash strips, and over a host graph's strips (its first sweep equal to
  the gather's but at CDF-boundary rows).

``HeldLaunches`` holds the first launch of K1, K2, K3 and K4 at each
shape of a run against the plain version on the run's own inputs.

Graphs are at most ER(20k, 0.01) or BA(50k, 8).  The cases whose check is
about size or that run subprocesses are marked ``slow`` as well: the main
path at its cells' ER(100k, 0.01) (its launch counts, and K4 at the
chain's three palettes, at taboo 4 and at the strips' 8 chains), config 3
(ER(10^6, 0.001)) on both of its routes, BA(1M, 8)'s bucketed widths, the
spawned gloo ranks (the (2, 1) and (1, 2) geometries equal to the 1x1
run), the CLI lanes, the baseline and validation scripts and the
analysis batch.

Imports no JAX: ``python -m pytest --noconftest -m card
tests/test_torch_card_colorers.py`` on the card (``-m "card and not
slow"`` for the quick cases).
"""

import contextlib
import io
import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache, partial
from pathlib import Path

import numpy as np
import pytest
import torch

from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind, default_n_colors
from mcmc_colorer_tpu_torch.graph.generate import barabasi_albert, erdos_renyi
from mcmc_colorer_tpu_torch.models import luby as tl
from mcmc_colorer_tpu_torch.models import mcmc as tm
from mcmc_colorer_tpu_torch.models.base import check_coloring
from mcmc_colorer_tpu_torch.ops import firstfit as k3
from mcmc_colorer_tpu_torch.ops import hash_ell as k5
from mcmc_colorer_tpu_torch.ops import hash_packed as k6
from mcmc_colorer_tpu_torch.ops import hashgen
from mcmc_colorer_tpu_torch.ops import packed_nc as k1
from mcmc_colorer_tpu_torch.ops import propose_nc as k4
from mcmc_colorer_tpu_torch.ops import resample as k2
from mcmc_colorer_tpu_torch.utils.rng import ChainSources, TorchUniformSource

import kernel_times as kt  # the repo's root script, which imports no JAX either
from cdf_boundary import assert_boundary_only
from torch_card import card, k2_agrees, k4_agrees  # noqa: F401  (card: the fixture)

ROOT = Path(__file__).resolve().parents[1]
PKG = str(ROOT / "mcmc_colorer_tpu_torch")
KERNELS = {"K1": k1, "K2": k2, "K3": k3, "K4": k4, "K5": k5, "K6": k6}
BD = ProposalKind.BALANCE_DYNAMIC
N, P = 20_000, 0.01           # the hash graph of graph seed 0 most cases colour
MAIN_N = 100_000              # the main path's graph, ER(10^5, P) (cells er100k_p01.*)
BA_N, BA_M, BA_SEED = 50_000, 8, 4  # BASELINE config 4
DEADLINE_S = 300.0            # a spawn of gloo ranks is killed past it


# ------------------------------- helpers -------------------------------

@lru_cache(maxsize=None)
def er20k():
    """The host graph of the hash graph ER(20k, 0.01), graph seed 0 (the
    C++ re-derivation the resident colourers' ``host_graph`` gives)."""
    return hashgen.hash_er_graph(N, P, 0)


@lru_cache(maxsize=None)
def ba50k():
    return barabasi_albert(BA_N, BA_M, seed=BA_SEED)


def params_of(n_colors, **kw):
    return MCMCParams(n_colors=n_colors, proposal=BD, tailcut=True, **kw)


@contextlib.contextmanager
def launches():
    """{kernel: launches} made inside the block, filled in on exit."""
    before = {k: m.launches for k, m in KERNELS.items()}
    out = {}
    yield out
    out.update({k: m.launches - before[k] for k, m in KERNELS.items()})


def valid(g, r) -> bool:
    return check_coloring(g, r.colors) and (r.extra or {}).get("final_conflicts", 0) == 0


def host_syncs(fn):
    """(``fn()``, the operations in it that waited for the card) under
    torch's CUDA sync debug mode, each named by the innermost line of the
    package on its stack."""
    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(PKG)]
        sites.append(f"{Path(stack[-1].filename).name}:{stack[-1].lineno}" if stack else "?")

    with warnings.catch_warnings():
        # the mode's first use in a process warns once that it is a
        # prototype, naming no sync: let it pass unrecorded
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sites


def one_chain_syncs(graph, n_pad, n_nodes, params, block, sweep, ell=None, node_mask=None):
    """The chain core at one chain reads the host once a do-while body
    (after one that warms up) and, given ``ell``, once a tailcut round."""
    dev = node_mask.device if node_mask is not None else ell.node_mask.device
    sources = ChainSources([TorchUniformSource(5, 0, dev)], dev)
    st = tm._chain_init(n_pad, n_nodes, params, sources, dev, node_mask=node_mask)
    body = partial(tm._chain_body, params=params, block=block, n_nodes=n_nodes,
                   sources=sources, sweep=sweep)
    run1 = np.ones(1, bool)
    sites = []
    for _ in range(4):
        st, got = host_syncs(lambda: body(graph, st, run1))
        sites.append(got)
    assert all(len(x) == 1 for x in sites[1:]), sites
    if ell is not None:
        tc = tm.TailcutState(tm._tailcut_init(ell, st.colors[0], params=params)[0][None],
                             st.conf_last.copy(), np.zeros(1, np.int64), np.zeros(1, bool))
        _, got = host_syncs(lambda: tm._tailcut_body(ell, tc, run1, sources, params=params))
        assert len(got) == 1, got


def frontier_syncs(graph, colors, taboo, cnt, params, cap):
    """From a chain's state: a frontier iteration reads the host once (its
    statistics), after one that warms up; a tailcut round never."""
    from mcmc_colorer_tpu_torch.models.mcmc_active import _active_iteration, _tailcut_round
    from mcmc_colorer_tpu_torch.ops.neighbor import color_histogram

    src = TorchUniformSource(7, 0, colors.device)
    sites = []
    for _ in range(4):
        (colors, taboo, cnt, _), got = host_syncs(lambda: _active_iteration(
            graph, colors, taboo, cnt, src, cap=cap, params=params, backend="pallas"))
        sites.append(got)
    assert all(len(x) == 1 for x in sites[1:]), sites
    ordered = torch.argsort(color_histogram(colors, params.n_colors, graph.node_mask),
                            stable=True).to(torch.int32)
    _, got = host_syncs(lambda: _tailcut_round(graph, colors, cnt, ordered, src, cap=cap,
                                               params=params))
    assert not got, got


class HeldLaunches(kt.Capture):
    """The first launch of K1, K2, K3 and K4 at each shape while runs go,
    its inputs kept (``kernel_times.Capture``); ``check`` holds each
    against the plain version on the inputs the run gave it (K1 and K3
    exactly, K3's tailcut call on fresh outputs, K2 under ``k2_agrees`` in
    the shape's regime and forced to L2, K4 under ``k4_agrees``) and, with
    more than one chain, against one launch a chain, exactly.  ``check`` returns the kernels it held."""

    HELD = ("K1", "K2", "K3", "K4")
    # the arguments with a chain axis where there is one (K4's always)
    CHAIN_ARGS = {"K1": (1,), "K2": (1, 2, 3, 5, 6), "K3": (1, 4), "K4": (0, 1, 2, 3, 5)}

    def __init__(self):
        super().__init__({k: KERNELS[k] for k in self.HELD})

    def check(self):
        for (_, kernel, _), (_, (a, kw)) in self.seen.items():
            cuda = self.orig[kernel]
            if kernel == "K3" and kw.get("flag") is not None:
                self._k3_tailcut_holds(cuda, a, kw)
                continue
            plain, _ = kt.plain_call(kernel, self.mods, a, kw)
            want = plain()
            staged = kernel == "K2" and k2.sweep_shape(a[1].shape[-1], a[8].n_colors).staged
            for l2 in ({}, {"_l2": True}) if staged else ({},):
                self._holds(kernel, cuda, cuda(*a, **kw, **l2), want, a, {**kw, **l2})
        return sorted({k for _, k, _ in self.seen})

    @staticmethod
    def _k3_tailcut_holds(cuda, a, kw):
        """K3's tailcut call (the ELL tailcut's first pass) on fresh
        outputs: first fit, flag and count equal the plain version's on
        the launch's rows, and each chain's equal its launch alone."""
        neigh, colors = a[0], a[1]
        rows = slice(kw["row0"], kw["row0"] + neigh.shape[0])

        def call(fn, cols):
            out = dict(row0=kw["row0"], out=torch.zeros_like(cols),
                       flag=torch.zeros(cols.shape, dtype=torch.bool, device=cols.device),
                       count=torch.zeros(cols.shape[:-1], dtype=torch.int64,
                                         device=cols.device))
            fn(neigh, cols, *a[2:], **out)
            return [out["out"][..., rows], out["flag"][..., rows], out["count"]]

        got = call(cuda, colors)
        assert all(torch.equal(x, y) for x, y in zip(got, call(k3.first_fit_plain, colors)))
        if colors.dim() == 2 and colors.shape[0] > 1:
            for c in range(colors.shape[0]):
                single = call(cuda, colors[c:c + 1].contiguous())
                assert all(torch.equal(x[c], y[0]) for x, y in zip(got, single)), c

    def _one(self, kernel, a, c):
        """The arguments of chain ``c``'s launch alone (K4's keep a chain
        axis of 1)."""
        pick = (lambda x: x[c:c + 1]) if kernel == "K4" else (lambda x: x[c])  # noqa: E731
        return [pick(x).contiguous() if i in self.CHAIN_ARGS[kernel] and x is not None else x
                for i, x in enumerate(a)]

    def _holds(self, kernel, cuda, got, want, a, kw):
        chains = a[0].shape[0] if kernel == "K4" else a[1].shape[0] if a[1].dim() == 2 else 0
        for c in range(max(chains, 1)):
            one = self._one(kernel, a, c) if chains else list(a)
            pick = (lambda x: x[c]) if chains else (lambda x: x)  # noqa: E731
            if kernel == "K4":
                k4_agrees(got, want, a, c)
            elif kernel == "K2":
                k2_agrees([pick(x) for x in got], [pick(x) for x in want], one[:7], a[8])
            else:
                assert torch.equal(pick(got), pick(want)), kernel
            if chains > 1:
                single = cuda(*one, **kw)
                if kernel == "K4":
                    assert all(torch.equal(x[c], y[0]) for x, y in zip(got, single)), kernel
                elif kernel == "K2":
                    assert all(torch.equal(x[c], y) for x, y in zip(got[:3], single[:3]))
                    assert int(got[3][c]) == int(single[3])
                else:
                    assert torch.equal(got[c], single), kernel


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def nccl_world_of_one():
    """A one-rank NCCL process group, so a 1x1 mesh's collectives run
    through NCCL."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def sharded_digest(result):
    """What two sharded runs must share: the best colours, iterations,
    trace, summaries and the extra but its times."""
    best, summ = result
    times = ("chain_seconds", "tailcut_seconds", "setup_seconds")
    return (best.colors.tolist(), best.iterations, best.conflict_trace.tolist(),
            {k: v for k, v in best.extra.items() if k not in times}, summ)


def ensemble_digest(result):
    """What two ensemble runs must share: the best colours, iterations,
    trace, the extra but its time, and the summaries."""
    best, summ = result
    return (best.colors.tolist(), best.iterations, best.conflict_trace.tolist(),
            {k: v for k, v in best.extra.items() if k != "chain_seconds"}, summ)


def chain_colors(c, seed):
    """Every chain's colours where the sharded colourer ``c``'s chain phase
    ends, gathered over its mesh from each chain group's first shard."""
    st = c._run_sharded_segment(c.init_state(seed), c.params.max_iterations)
    parts = c.mesh.gather_objects(st.colors[:, :c.graph.n].cpu().numpy())
    return np.concatenate([x for r, x in enumerate(parts) if r % c.mesh.shards == 0])


# ------------------------------- cases -------------------------------

def case_resident(card):
    """The main path: ``ResidentMCMCColorer`` builds its graph anew (K6 once),
    K1 and K4 a sweep; its host graph is the C++ re-derivation; then a
    palette at max degree / 2 that the tailcut must repair."""
    from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer

    hashgen._PACKED_CACHE.clear()
    with launches() as n:
        c = ResidentMCMCColorer(N, P, graph_seed=0, params=params_of(0), device=card)
        r = c.run(seed=5)
    x = r.extra
    assert n["K6"] == 1 and n["K1"] > 0 and n["K4"] == x["sweeps"] > 0, n
    g = c.host_graph()
    assert g.simple_certified and (g.n_edges, g.max_degree) == (c.n_edges, c.max_degree)
    assert r.colors.shape == (N,) and 0 <= r.colors.min() and r.colors.max() < c.params.n_colors
    assert valid(g, r)
    c0 = ResidentMCMCColorer(N, P, graph_seed=3, device=card)
    tight = params_of(max(4, c0.max_degree // 2), max_iterations=60)
    c = ResidentMCMCColorer(N, P, graph_seed=3, params=tight, device=card)
    r = c.run(seed=5)
    assert r.extra["tailcut_rounds"] >= 1 and valid(c.host_graph(), r)


def case_ell_packed_hastings(card):
    """Over the resident graph's host graph: the ELL chain (K2 a sweep, its
    rectangle built on the card from the CSR equal to the host's build),
    the packed chain (its A, built from the ELL, equal to the resident A
    on the real rows and 0 elsewhere; K1 a sweep), Hastings over K2 and
    over K1, and the plain route (no K2)."""
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
    from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer

    g = er20k()
    p = params_of(g.max_degree)
    with launches() as n:
        r = MCMCColorer(g, p, backend="pallas", device=card).run(seed=5)
    assert n["K2"] == r.extra["sweeps"] > 0 and valid(g, r)
    n_pad, d_pad = 20_480, -(-g.max_degree // 128) * 128
    a = g._build_ell(n_pad, d_pad, card, True, None)
    b = g._build_ell(n_pad, d_pad, card, False, None)
    assert torch.equal(a.neighbors, b.neighbors)
    res = ResidentMCMCColorer(N, P, 0, params=p, device=card)
    m = MCMCColorer(g, p, backend="packed", device=card)
    nr, nw = res.adj.shape
    assert torch.equal(m._adj[:nr, :nw], res.adj)
    assert not m._adj[nr:].any() and not m._adj[:, nw:].any()
    with launches() as n:
        r = m.run(seed=5)
    assert n["K1"] == r.extra["sweeps"] > 0 and valid(g, r)
    hp = params_of(g.max_degree, max_iterations=30, hastings=True, lambda_=25.0)
    for make, kernel in ((lambda: MCMCColorer(g, hp, device=card), "K2"),
                         (lambda: ResidentMCMCColorer(N, P, 0, params=hp, device=card), "K1"),
                         (lambda: MCMCColorer(g, params_of(g.max_degree, max_iterations=30),
                                              backend="xla", device=card), None)):
        with launches() as n:
            r = make().run(seed=7)
        assert valid(g, r)
        assert n[kernel] > 0 if kernel else n["K2"] == 0, n


def _vff_k3_sites(c, gff_colors):
    """K3 exactly against its plain version at VFF's two call sites, with
    the ``allow`` and ``cur`` of phase 2's first round from GreedyFF's
    colours: the first band of the full pass and the frontier round at
    its cap."""
    from mcmc_colorer_tpu_torch.models.mcmc_active import _buckets, pick_cap
    from mcmc_colorer_tpu_torch.models.vff import _phase2_start
    from mcmc_colorer_tpu_torch.ops.neighbor import frontier_ids, take_rows

    ell, max_colors, dev = c.ell, c.max_colors, c.device
    colors = torch.zeros((ell.n_pad,), dtype=torch.int32, device=dev)
    colors[: ell.n_nodes] = torch.from_numpy(gff_colors).to(dev)
    n_used, gamma, bins, unb, _ = _phase2_start(ell, colors, max_colors)
    allow = ((bins < gamma) & (torch.arange(max_colors, device=dev) < n_used)).to(torch.int32)
    s, e = next(tm._bands(ell.n_pad, ell.d_pad))
    sites = [(ell.neighbors[s:e], colors[s:e])]
    cap = pick_cap(_buckets(ell.n_pad, c._min_bucket, c._bucket_factor), int(unb.sum()))
    ids, ok = frontier_ids(unb, cap)
    cur = torch.where(ok, colors[ids.clamp(max=ell.n_pad - 1).to(torch.int64)], max_colors)
    sites.append((take_rows(ell, ids, ok), cur))
    for rows, cur in sites:
        assert torch.equal(k3.first_fit_cuda(rows, colors, allow, max_colors, cur),
                           k3.first_fit_plain(rows, colors, allow, max_colors, cur))


def case_greedy_vff(card):
    """GreedyFF's frontier loop equals its full loop; VFF full and frontier,
    with K3 and with its plain version, end alike, phase 2 included (under
    the livelock fallback the result is GreedyFF's), and phase 2 moves
    vertices; K3 at VFF's call sites on the run's own inputs."""
    from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer
    from mcmc_colorer_tpu_torch.models.vff import VFFColorer

    g = er20k()
    with launches() as n:
        full = GreedyFFColorer(g, device=card).run()
    assert n["K3"] > 0 and check_coloring(g, full.colors)
    with launches() as n:
        front = GreedyFFColorer(g, active=True, device=card).run()
    assert n["K3"] > 0
    assert np.array_equal(front.colors, full.colors) and front.iterations == full.iterations
    runs = {}
    for active in (False, True):
        for backend in ("pallas", "xla"):
            c = VFFColorer(g, active=active, backend=backend, device=card)
            with launches() as n:
                r = c.run()
            assert (n["K3"] > 0) == (backend == "pallas"), n
            assert check_coloring(g, r.colors) and int(r.colors.max()) < r.n_colors
            runs[active, backend] = (r, c.phase2_colors)
            if (active, backend) == (False, "pallas"):
                _vff_k3_sites(c, full.colors)
    r0, p0 = runs[False, "pallas"]
    for r, p2 in runs.values():
        assert np.array_equal(r.colors, r0.colors) and np.array_equal(p2, p0)
        assert (r.n_colors, r.iterations, r.extra) == (r0.n_colors, r0.iterations, r0.extra)
    assert int((p0 != full.colors).sum()) > 0


def case_luby(card):
    """Luby's gather and frontier loops, and resident Luby on the hash graph
    (K1, one launch a shape a round), which equals the gather loop on the
    same graph padded alike with the same draws; K1 exactly at resident
    Luby's two shapes on its own adjacency."""
    from mcmc_colorer_tpu_torch.ops.dense_adj import n_col_pad_of

    g = er20k()
    for active in (False, True):
        r = tl.LubyColorer(g, active=active, device=card).run(seed=5)
        assert check_coloring(g, r.colors) and int(r.colors.min()) >= 0
    c = tl.LubyColorer(None, resident_spec=(N, P, 0), device=card)
    with launches() as n:
        r = c.run(seed=5)
    assert n["K1"] == 2 * r.extra["rounds"] > 0 and check_coloring(g, r.colors)
    ell = g.to_ell(pad_nodes_to=2048, device=card)
    assert ell.n_pad == c.n_pad
    colors, _, _ = tl._run_luby(ell, TorchUniformSource(5, 0, card))
    assert np.array_equal(colors[:N].cpu().numpy(), r.colors)
    u = torch.rand((c.n_pad,), generator=torch.Generator(device=card).manual_seed(5),
                   device=card)
    sel = c.node_mask & (u < 0.5)
    for colors, n_col in ((torch.where(sel, c.rank_class, -1), c.n_classes),
                          (torch.where(sel & (u < 0.01), 0, -1).to(torch.int32), 1)):
        ncp = n_col_pad_of(n_col)
        assert torch.equal(k1.packed_nc_cuda(c.adj, colors, ncp),
                           k1.packed_nc_reference(c.adj, colors, ncp))


def case_frontier_chains(card):
    """The frontier chain over the ELL at numColRatio 1 and 4: K2 once a
    full sweep and once a frontier iteration, the kept cnt a recount; the
    resident frontier at ε 1e-8 and 1e-4 (where the frontier has work): K2
    once a frontier iteration, K1 once a full sweep, for the cnt and for
    the NC tailcut's rounds, and its rows unpacked from A equal to the
    host ELL's, sorted.  Both frontiers run, and an iteration reads the
    host once."""
    from mcmc_colorer_tpu_torch.models.mcmc_active import (
        ActiveMCMCColorer, PackedRows, _cnt_of, _cnt_of_packed,
    )
    from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer
    from mcmc_colorer_tpu_torch.ops.dense_adj import packed_rows_to_ids

    g = er20k()
    frontier = 0
    for ratio in (1.0, 4.0):
        p = params_of(max(4, int(g.max_degree / ratio)))
        c = ActiveMCMCColorer(g, p, device=card)
        with launches() as n:
            r = c.run(seed=31)
        x = r.extra
        its = sum(x["frontier_iterations"].values())
        assert n["K2"] == x["full_sweeps"] + its and valid(g, r)
        ch = c._chain(TorchUniformSource(31, 0, card))
        assert ch.cnt is None or torch.equal(ch.cnt, _cnt_of(c.ell, ch.colors))
        if its:
            frontier_syncs(c.ell, ch.colors, ch.taboo, ch.cnt, p, max(x["frontier_iterations"]))
        frontier += its
    assert frontier > 0
    frontier = 0
    for eps in (1e-8, 1e-4):
        c = ResidentMCMCColorer(N, P, 0, params=params_of(0, epsilon=eps), active=True,
                                device=card)
        with launches() as n:
            r = c.run(seed=5)
        x = r.extra
        its, tc = sum(x["frontier_iterations"].values()), x["tailcut_rounds"]
        assert n["K2"] == its and n["K1"] == x["sweeps"] + 1 + tc + (tc > 0), (n, x)
        assert valid(g, r)
        if its:
            graph = PackedRows(c.adj, c.d_row, c.n, c.node_mask)
            gen = torch.Generator(device=card).manual_seed(17)
            colors = torch.randint(0, c.params.n_colors, (c.n_pad,), generator=gen, device=card,
                                   dtype=torch.int32)
            colors[c.n:] = c.params.n_colors
            cnt = _cnt_of_packed(c.adj, colors, params=c.params, node_mask=c.node_mask)
            frontier_syncs(graph, colors, torch.zeros_like(cnt), cnt, c.params,
                           max(x["frontier_iterations"]))
        frontier += its
    assert frontier > 0
    ell = g.to_ell(pad_nodes_to=2048, device=card)
    assert ell.n_pad == c.n_pad and ell.d_pad >= c.d_row
    ids = torch.randperm(N - 1, generator=torch.Generator(device=card).manual_seed(17),
                         device=card)[:299].to(torch.int32)
    ids = torch.cat([ids, ids.new_tensor([N - 1])]).sort().values
    rows = packed_rows_to_ids(c.adj.index_select(0, ids), c.d_row, c.n_pad)
    assert torch.equal(rows, ell.neighbors.index_select(0, ids).sort(dim=1).values[:, :c.d_row])


def case_config4(card):
    """BASELINE config 4: BA(50k, 8) written in the network-repository
    layout (two self-arcs), converted, stripped and loaded by the native
    importer; then every device colourer flat and degree-bucketed.  The
    bucketed chain launches K2 once a degree class a sweep; GreedyFF's
    colours are one with K3 and with its plain version, full and
    frontier, flat and bucketed."""
    from mcmc_colorer_tpu_torch.graph import io as gio
    from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer
    from mcmc_colorer_tpu_torch.models.luby import LubyColorer
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
    from mcmc_colorer_tpu_torch.models.mcmc_active import ActiveMCMCColorer
    from mcmc_colorer_tpu_torch.models.vff import VFFColorer

    g0 = ba50k()
    with tempfile.TemporaryDirectory() as td:
        raw = os.path.join(td, "soc-sample.mtx")
        u = np.repeat(np.arange(g0.n, dtype=np.int64), g0.degrees)
        v = g0.cols.astype(np.int64)
        keep = u < v
        with open(raw, "w") as f:
            f.write("%% networkrepository sample (BA 50k regime)\n")
            f.write(f"{g0.n} {g0.n} {g0.n_edges}\n")
            f.writelines(f"{a} {b}\n" for a, b in zip(u[keep], v[keep]))
            f.write("7 7\n17 17\n")  # self-arcs, as real dumps have
        conv, clean = os.path.join(td, "conv.txt"), os.path.join(td, "clean.txt")
        gio.convert_network_repository(raw, conv)
        assert gio.strip_self_arcs(conv, clean) == 2
        g = gio.load_edge_list(clean)
    assert (g.n, g.n_edges, g.max_degree) == (g0.n, g0.n_edges, g0.max_degree)
    p = params_of(g.max_degree)
    gff = {}
    with HeldLaunches() as held:
        for layout in ("flat", "bucketed"):
            c = MCMCColorer(g, p, backend="pallas", layout=layout, device=card)
            with launches() as n:
                r = c.run(seed=41)
            pieces = len(c.ell.slices) if layout == "bucketed" else 1
            assert n["K2"] == r.extra["sweeps"] * pieces and valid(g, r)
            assert valid(g, ActiveMCMCColorer(g, p, layout=layout, device=card).run(seed=41))
        hp = params_of(g.max_degree, hastings=True, lambda_=25.0, max_iterations=30)
        assert valid(g, MCMCColorer(g, hp, layout="bucketed", device=card).run(seed=41))
        for layout in ("flat", "bucketed"):
            for active in (False, True):
                gff[layout, active] = GreedyFFColorer(g, active=active, layout=layout,
                                                      device=card).run()
                assert check_coloring(g, gff[layout, active].colors)
                for make in (VFFColorer, LubyColorer):
                    r = make(g, active=active, layout=layout, device=card).run(seed=5)
                    assert check_coloring(g, r.colors)
    assert {"K2", "K3"} <= set(held.check())
    for layout in ("flat", "bucketed"):
        gff[layout, "plain"] = GreedyFFColorer(g, backend="xla", layout=layout,
                                               device=card).run()
        for other in (True, "plain"):
            assert np.array_equal(gff[layout, other].colors, gff[layout, False].colors)


def case_stepped(card):
    """The stepped chain at numColRatio 4 in segments of 4 with a
    checkpoint (K2 a sweep); a run resumed from a checkpoint half-way
    equals the uninterrupted one; ``inspect`` on the card equals it on a
    CPU copy; a stepped body reads the host once; the debugger's ε edit
    reaches the next segment; ``MCMCColorer`` under ``MCMC_COLORER_TRACE``
    gives the untraced colouring and a TRACE line a segment; the chain
    core at one chain reads the host once a body and a tailcut round."""
    from mcmc_colorer_tpu_torch.models.chain_api import ChainState, SteppedMCMC
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
    from mcmc_colorer_tpu_torch.utils.dbg import DebugAttach

    g = er20k()
    p = params_of(default_n_colors(g.max_degree, 4.0))
    with tempfile.TemporaryDirectory() as td:
        a = SteppedMCMC(g, p, backend="pallas", device=card)
        ck = os.path.join(td, "stepped.npz")
        with launches() as n, HeldLaunches() as held:
            ra = a.run(seed=5, segment=4, checkpoint_path=ck)
        assert "K2" in held.check()
        assert valid(g, ra) and ra.iterations >= 4
        assert n["K2"] == ra.iterations and n["K3"] >= (ra.extra["tailcut_rounds"] > 0)
        assert a.load_checkpoint(ck).iteration == ra.iterations
        b = SteppedMCMC(g, p, backend="pallas", device=card)
        st = b.step(b.init_state(5), n_steps=ra.iterations // 2)
        b.save_checkpoint(st, os.path.join(td, "half.npz"))
        rc = SteppedMCMC(g, p, backend="pallas", device=card).run(
            seed=5, resume_from=os.path.join(td, "half.npz"))
    assert np.array_equal(rc.colors, ra.colors) and rc.iterations == ra.iterations
    assert rc.extra["final_conflicts"] == ra.extra["final_conflicts"]
    info = b.inspect(st)
    cpu = SteppedMCMC(g, p, backend="pallas", device="cpu").inspect(
        ChainState(st.colors.cpu(), st.taboo.cpu(), st.rng, st.iteration, st.conflicts))
    assert all(info[k] == cpu[k] for k, v in info.items() if isinstance(v, int))
    assert np.array_equal(info["histogram"], cpu["histogram"])
    _, sites = host_syncs(lambda: b.step(st, n_steps=1))
    assert len(sites) == 1, sites
    d = SteppedMCMC(g, p.replace(tailcut=False), backend="pallas", device=card)
    seen, step = [], d.step

    def spy(state, n_steps=1, epsilon=None):
        seen.append(epsilon)
        return step(state, n_steps, epsilon=epsilon)

    d.step = spy
    out = io.StringIO()
    dbg = DebugAttach(input=iter(["p free", "e epsilon 0.05", "c", "q"]), output=out,
                      break_every=True)
    rd = d.run(seed=5, segment=1, dbg=dbg)
    assert seen == [None, 0.05] and dbg.quit and rd.iterations == 2
    assert out.getvalue().splitlines()[1].startswith("min ")
    m = MCMCColorer(g, p, backend="pallas", device=card)
    plain = m.run(seed=5)
    one_chain_syncs(m.ell, m.ell.n_pad, m.ell.n_nodes, p, m.block, tm._sweep_pallas_fused,
                    ell=m.ell, node_mask=m.ell.node_mask)
    err = io.StringIO()
    os.environ["MCMC_COLORER_TRACE"] = "1"
    try:
        with contextlib.redirect_stderr(err):
            traced = m.run(seed=5)
    finally:
        del os.environ["MCMC_COLORER_TRACE"]
    lines = [ln for ln in err.getvalue().splitlines() if ln.startswith("Max Free Colors: ")]
    assert np.array_equal(traced.colors, plain.colors) and valid(g, traced)
    assert len(lines) == len(traced.extra.get("free_color_trace_segments", [])) >= 1


def _chains_equal_one_chain_runs(make_one, summaries, best, seed, device):
    """Each chain c of an ensemble against a one-chain run fed chain c's
    source: iterations, conflicts and class-size std, and the best chain's
    colours."""
    one = make_one()
    for c, s in enumerate(summaries):
        r = one.run(seed, source=TorchUniformSource(seed, 0, device, chain=c))
        assert (r.iterations, r.extra["final_conflicts"]) == (s["iterations"], s["conflicts"])
        assert float(r.histogram.std()) == s["class_std"]
        if c == best.extra["best_chain"]:
            assert np.array_equal(r.colors, best.colors)


def case_ensembles(card):
    """``EnsembleMCMCColorer``: 8 chains flat on ER(20k, 0.01) and 4
    bucketed at config 4, K2 once a rectangle a batched body, each chain
    equal to a one-chain run fed its source, and each run's first batched
    K2 and K3 launch equal to one launch a chain."""
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
    from mcmc_colorer_tpu_torch.parallel.chains import EnsembleMCMCColorer

    for g, chains, layout, seed in ((er20k(), 8, "flat", 5), (ba50k(), 4, "bucketed", 41)):
        p = params_of(g.max_degree)
        ens = EnsembleMCMCColorer(g, p, chains, backend="pallas", layout=layout, device=card)
        with launches() as n, HeldLaunches() as held:
            best, summ = ens.run(seed=seed)
        pieces = len(ens.ell.slices) if layout == "bucketed" else 1
        assert valid(g, best)
        assert n["K2"] == best.extra["sweeps"] * pieces > 0 and n["K3"] > 0, n
        assert "K2" in held.check()
        _chains_equal_one_chain_runs(
            lambda: MCMCColorer(g, p, backend="pallas", layout=layout, device=card),
            summ, best, seed, card)


def case_resident_ensemble(card):
    """The resident ensemble (4 chains): K1 once a sweep, once for the
    final count where a chain stopped at the cap and twice a tailcut
    round; a checkpoint written after 2 iterations resumes equal to the
    uninterrupted run; the ``matmul`` ensemble over the host graph, K1 a
    sweep; their batched K1 launches equal to one launch a chain; a
    resident do-while body of one chain reads the host once; the resident
    TRACE."""
    from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer
    from mcmc_colorer_tpu_torch.parallel.chains import EnsembleMCMCColorer

    g = er20k()
    p = params_of(g.max_degree)

    def resident(params=p):
        return ResidentMCMCColorer(N, P, 0, params=params, n_chains=4, device=card)

    with launches() as n, HeldLaunches() as held:
        full, summ = resident().run_ensemble(seed=5)
    x = full.extra
    assert valid(g, full)
    capped = any(c["iterations"] >= p.max_iterations for c in summ)
    assert n["K1"] == x["sweeps"] + capped + 2 * x["tailcut_rounds"], (n, x)
    assert "K1" in held.check()
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "resident.npz")
        resident(p.replace(max_iterations=2, tailcut=False)).run_ensemble(
            seed=5, checkpoint_path=ck)
        res, summ_r = resident().run_ensemble(seed=5, resume_from=ck)
    assert np.array_equal(res.colors, full.colors) and summ_r == summ
    ens = EnsembleMCMCColorer(g, p, 4, backend="matmul", device=card)
    with launches() as n, HeldLaunches() as held:
        bm, _ = ens.run(seed=5)
    assert valid(g, bm) and n["K1"] == bm.extra["sweeps"] > 0
    assert "K1" in held.check()
    c = ResidentMCMCColorer(N, P, 0, params=p, device=card)
    one_chain_syncs(c.adj, c.n_pad, c.n, p, c.block, tm._sweep_matmul, node_mask=c.node_mask)
    os.environ["MCMC_COLORER_TRACE"] = "1"
    try:
        tr = ResidentMCMCColorer(N, P, 0, params=p, device=card).run(seed=5)
    finally:
        del os.environ["MCMC_COLORER_TRACE"]
    assert tr.extra.get("free_color_trace_segments") and valid(g, tr)


def case_sharded(card):
    """``ShardedMCMCColorer`` with 8 chains on a 1x1 mesh under a one-rank
    NCCL group: full sweeps, the frontier, Hastings, pooled annealing and
    a run stopped after 2 sweeps for the rank-space tailcut (K3); then 2
    chains in segments of 4 with checkpoints, and resumed from a
    checkpoint after 3 sweeps, both equal to the uninterrupted run."""
    from mcmc_colorer_tpu_torch.parallel.mesh import make_mesh
    from mcmc_colorer_tpu_torch.parallel.sharded import AnnealConfig, ShardedMCMCColorer

    g = er20k()
    with nccl_world_of_one(), HeldLaunches() as held:
        mesh = make_mesh(1, 1)
        assert mesh.distributed and mesh.device == card
        k3_total = 0
        for name, pkw, ckw in (
            ("full", {}, {}),
            ("frontier", {}, dict(active_cap=g.n // 8)),
            ("hastings", dict(hastings=True, lambda_=25.0, max_iterations=30), {}),
            ("anneal", {}, dict(anneal=AnnealConfig(enabled=True))),
            ("tailcut after 2 sweeps", dict(max_iterations=2), {}),
        ):
            c = ShardedMCMCColorer(g, params_of(g.max_degree, **pkw), mesh, n_chains=8,
                                   backend="pallas", **ckw)
            with launches() as n:
                best, _ = c.run(seed=5)
            assert valid(g, best) and n["K2"] > 0, name
            assert name != "frontier" or best.extra["frontier_sweeps"] > 0
            k3_total += n["K3"]
        assert k3_total > 0 and {"K2", "K3"} <= set(held.check())

        def make():
            return ShardedMCMCColorer(g, params_of(g.max_degree), mesh, n_chains=2,
                                      backend="pallas")

        ref = sharded_digest(make().run(seed=5))
        with tempfile.TemporaryDirectory() as td:
            ck = os.path.join(td, "sharded.npz")
            assert sharded_digest(make().run(seed=5, segment=4, checkpoint_path=ck)) == ref
            c1 = make()
            c1.save_checkpoint(c1._run_sharded_segment(c1.init_state(5), 3), ck)
            assert sharded_digest(make().run(seed=5, resume_from=ck)) == ref


def case_strips(card):
    """The sharded colourer on adjacency strips, 8 chains on the 1x1 NCCL
    mesh: the resident strips (K1 for NC, K4 for the proposal) with full
    sweeps, the frontier (rows unpacked from the strip), Hastings, and a
    run stopped after 3 sweeps for the strip tailcut; then the host
    graph's strips (``backend="matmul"``), whose initial counts equal the
    gather's and whose first sweep's samples equal the ``pallas`` run's
    but at CDF-boundary rows, and a valid run."""
    from mcmc_colorer_tpu_torch.models.mcmc import _p_eff, _proposal_q
    from mcmc_colorer_tpu_torch.ops.neighbor import neighbor_colors, occupancy_matrix
    from mcmc_colorer_tpu_torch.parallel.mesh import make_mesh
    from mcmc_colorer_tpu_torch.parallel.sharded import ShardedMCMCColorer

    g = er20k()
    with nccl_world_of_one(), HeldLaunches() as held:
        mesh = make_mesh(1, 1)
        for name, pkw, ckw, need in (
            ("full", {}, {}, ("K1", "K4")),
            ("frontier", {}, dict(active_cap=N // 8), ("K1", "K2")),
            ("hastings", dict(hastings=True, lambda_=25.0, max_iterations=30), {}, ("K1",)),
            ("tailcut", dict(max_iterations=3), {}, ("K1",)),
        ):
            c = ShardedMCMCColorer(None, params_of(g.max_degree, **pkw), mesh, n_chains=8,
                                   resident_spec=(N, P, 0), **ckw)
            with launches() as n:
                best, _ = c.run(seed=5)
            assert valid(g, best) and all(n[k] > 0 for k in need), (name, n)
            assert name != "frontier" or best.extra["frontier_sweeps"] > 0
            assert name != "tailcut" or best.extra["tailcut_rounds"] > 0
        p = params_of(g.max_degree)
        cm = ShardedMCMCColorer(g, p, mesh, n_chains=8, backend="matmul")
        cp = ShardedMCMCColorer(g, p, mesh, n_chains=8, backend="pallas")
        sm, sp = cm.init_state(5), cp.init_state(5)
        assert torch.equal(sm.colors, sp.colors) and torch.equal(sm.cnt, sp.cnt)
        eps = torch.full((), float(cm._eps_eff(sm)), dtype=torch.float32, device=card)
        ks = list(range(8))
        star_m = cm._full_branch(sm, ks, eps)[0]
        star_p = cp._full_branch(sp, ks, eps)[0]
        p_eff = _p_eff(sm.colors, p, g.n, cm._full_real)
        for k in ks:
            src = TorchUniformSource(5, 0, card, chain=k)
            src.next(g.n)  # the initial colouring's
            u = src.next(g.n)
            occ = occupancy_matrix(neighbor_colors(cm.neighbors[:g.n], sm.colors[k]), p.n_colors)
            cdf = torch.cumsum(_proposal_q(sm.colors[k, :g.n], occ, p, p_eff[k], eps,
                                           p.n_colors), dim=1)
            assert_boundary_only(star_p[k, :g.n].cpu().numpy(), star_m[k, :g.n].cpu().numpy(),
                                 u.cpu().numpy(), cdf.cpu().numpy(), g.n)
        with launches() as n:
            best, _ = cm.run(seed=5)
        assert valid(g, best) and n["K1"] > 0
        assert "K1" in held.check()


# --------------------------- cases marked slow ---------------------------

def ell_conflicts(ell, colors, rows: int = 1 << 15) -> int:
    """Conflict edges of ``colors`` (host, [n]) over ``ell``'s rows,
    counted on the card a block of rows at a time."""
    n = ell.n_nodes
    c = torch.full((ell.n_pad + 1,), -1, dtype=torch.int64, device=ell.neighbors.device)
    c[:n] = torch.as_tensor(colors, device=c.device)
    twice = 0
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        twice += int((c[ell.neighbors[r0:r1].long()] == c[r0:r1, None]).sum())
    return twice // 2


def case_main_path(card):
    """The main path at its cells' size, ER(100k, 0.01): ``ResidentMCMCColorer``
    builds its graph anew (K6 once) and launches K4 once a sweep, each K1
    and K4 launch shape of the run held against the plain version; then
    K4 on NC that K1 counts over that A, at the chain's palettes of
    numColRatio 1, 2 and 4, at the max degree's with taboo counters up to
    4, and with the strips' 8 chains, held alike."""
    from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer
    from mcmc_colorer_tpu_torch.ops.dense_adj import neighbor_color_counts

    hashgen._PACKED_CACHE.clear()
    with launches() as n, HeldLaunches() as held:
        c = ResidentMCMCColorer(MAIN_N, P, graph_seed=0, params=params_of(0), device=card)
        r = c.run(seed=5)
    x = r.extra
    assert n["K6"] == 1 and n["K1"] > 0 and n["K4"] == x["sweeps"] > 0, n
    assert 0 <= r.colors.min() and r.colors.max() < c.params.n_colors
    assert valid(c.host_graph(), r)
    assert held.check() == ["K1", "K4"]
    gen = torch.Generator(device=card).manual_seed(5)
    shapes = [(default_n_colors(c.max_degree, ratio), 0, 1) for ratio in (1.0, 2.0, 4.0)]
    shapes += [(c.max_degree, 4, 1), (c.max_degree, 0, 8)]  # (palette, taboo, chains)
    with HeldLaunches() as held:
        for n_colors, taboo_max, chains in shapes:
            p = MCMCParams(n_colors=n_colors, proposal=BD, taboo_iterations=taboo_max)
            colors = torch.randint(0, n_colors, (chains, c.n_pad), generator=gen, device=card,
                                   dtype=torch.int32)
            colors[:, c.n:] = n_colors
            nc = neighbor_color_counts(c.adj, colors, n_colors, c.node_mask)
            taboo = torch.randint(0, taboo_max + 1, colors.shape, generator=gen, device=card,
                                  dtype=torch.int32)
            unif = torch.rand(colors.shape, generator=gen, device=card)
            eps = torch.full((), p.epsilon, dtype=torch.float32, device=card)
            k4.propose_nc(nc, colors, taboo, unif, c.node_mask,
                          tm._p_eff(colors, p, c.n, c.node_mask), eps, p,
                          tm.choose_block_size(c.n_pad, n_colors))
    assert len(held.seen) == 9  # K1 at 4 shapes, K4 at 5
    assert held.check() == ["K1", "K4"]


def case_config3(card):
    """BASELINE config 3, ER(10^6, 0.001), on both routes.  With no host
    graph: ``HashGraph``'s flat ELL by K5 (two launches), the rectangle
    as wide as the max degree, the degrees twice the edges, no phantom
    row holding a neighbour; ``MCMCColorer`` over it at numColRatio 1, 2
    and 4 (K2 a sweep from L2, K3 in the tailcut, K5 not again), each
    colouring's conflicts counted on the card over K5's rows.  From the
    native sampler: the ELL built on the card from the CSR, the chain at
    numColRatio 1, GreedyFF, the frontier chain, and the sharded colourer
    with 2 chains on a 1x1 mesh (a million rows on the rank)."""
    from mcmc_colorer_tpu_torch.graph.container import HashGraph, degree_pad_for
    from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer, choose_block_size
    from mcmc_colorer_tpu_torch.models.mcmc_active import ActiveMCMCColorer
    from mcmc_colorer_tpu_torch.parallel.mesh import make_mesh
    from mcmc_colorer_tpu_torch.parallel.sharded import ShardedMCMCColorer

    n = 1_000_000
    with launches() as built:
        hg = HashGraph(n, 0.001, 0, device=card)
        ell = hg.to_ell(pad_nodes_to=choose_block_size(n, 1),
                        pad_degree_to=degree_pad_for(hg, "pallas"), device=card)
    assert built["K5"] == 2
    assert ell.d_pad == k5.d_pad_for(hg.max_degree, degree_pad_for(hg, "pallas"))
    assert int(ell.degrees.max()) == hg.max_degree
    assert int(ell.degrees.sum()) == 2 * hg.n_edges and not ell.degrees[n:].any()
    assert bool((ell.neighbors[n:] == ell.n_pad).all())
    assert not k2.sweep_shape(n, hg.max_degree).staged
    with HeldLaunches() as held:
        for ratio in (1.0, 2.0, 4.0):
            p = params_of(default_n_colors(hg.max_degree, ratio))
            c = MCMCColorer(hg, p, backend="pallas", device=card)
            assert c.ell is ell
            with launches() as k:
                r = c.run(seed=31)
            assert k["K2"] == r.extra["sweeps"] > 0 and k["K3"] > 0 and k["K5"] == 0, k
            assert ell_conflicts(ell, r.colors) == 0 and r.extra["final_conflicts"] == 0
            assert 0 <= r.colors.min() and r.colors.max() < p.n_colors
    assert held.check() == ["K2", "K3"]
    del c, ell, hg, held
    torch.cuda.empty_cache()
    g = erdos_renyi(n, 0.001, seed=3)
    p = params_of(g.max_degree)
    with launches() as k:
        r = MCMCColorer(g, p, backend="pallas", device=card).run(seed=31)
    assert k["K2"] == r.extra["sweeps"] and valid(g, r)
    with launches() as k:
        r = GreedyFFColorer(g, device=card).run()
    assert k["K3"] > 0 and check_coloring(g, r.colors)
    assert valid(g, ActiveMCMCColorer(g, params_of(g.max_degree // 4), device=card).run(31))
    with nccl_world_of_one(), HeldLaunches() as held:
        c = ShardedMCMCColorer(g, p, make_mesh(1, 1), n_chains=2, backend="pallas")
        with launches() as k:
            best, _ = c.run(seed=5)
        assert valid(g, best) and k["K2"] > 0 and "K2" in held.check()


def case_ba1m(card):
    """BA(1M, 8) from the native sampler (max degree in the thousands):
    the bucketed chain, K2 once a degree class a sweep, and the bucketed
    GreedyFF."""
    from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer

    g = barabasi_albert(1_000_000, BA_M, seed=BA_SEED, use_native=True)
    c = MCMCColorer(g, params_of(g.max_degree), backend="pallas", layout="bucketed",
                    device=card)
    with HeldLaunches() as held:
        with launches() as n:
            r = c.run(seed=41)
        assert n["K2"] == r.extra["sweeps"] * len(c.ell.slices) and valid(g, r)
        r = GreedyFFColorer(g, layout="bucketed", device=card).run()
        assert check_coloring(g, r.colors)
    assert held.check() == ["K2", "K3"]


def _gloo_rank(rank, world, port, out, seed):
    """A spawned rank of a gloo group on the one card: the 2-chain sharded
    ensemble on ER(20k, 0.01) at (2, 1), also resumed from the 1x1
    checkpoint at ``out``.ckpt, and at (1, 2); the resident strips, 8
    chains, at (1, 2); the 8-chain ensemble over a (2, 1) mesh.  Each
    rank writes its digests."""
    import torch.distributed as dist

    from mcmc_colorer_tpu_torch.parallel.chains import EnsembleMCMCColorer
    from mcmc_colorer_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from mcmc_colorer_tpu_torch.parallel.sharded import ShardedMCMCColorer

    torch.cuda.set_device(0)
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                           backend="gloo")
    g = er20k()
    p = params_of(g.max_degree)
    got = {}
    for geometry in ((2, 1), (1, 2)):
        c = ShardedMCMCColorer(g, p, make_mesh(*geometry), n_chains=2, backend="pallas")
        got[geometry] = (sharded_digest(c.run(seed=seed)), chain_colors(c, seed))
        if geometry == (2, 1):
            got["resume"] = (sharded_digest(c.run(seed=seed, resume_from=f"{out}.ckpt.npz")),
                             None)
    c = ShardedMCMCColorer(None, params_of(0), make_mesh(1, 2), n_chains=8,
                           resident_spec=(N, P, 0))
    got["strips"] = (sharded_digest(c.run(seed=seed)), None)
    ens = EnsembleMCMCColorer(g, p, 8, mesh=make_mesh(2, 1), backend="pallas")
    got["ensemble"] = (ensemble_digest(ens.run(seed=seed)), None)
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(got, f)
    dist.destroy_process_group()


def case_two_ranks(card):
    """Two gloo ranks spawned on the one card (NCCL refuses two ranks on
    one device): the sharded ensemble at (2, 1) and (1, 2) equal to the 1x1
    run, chain by chain where the chain phase ends, and (2, 1) resumed
    from a 1x1 checkpoint equal too; the resident strips at (1, 2), each
    rank generating its own strip, equal to the 1x1 run; the ensemble
    over a (2, 1) mesh equal to the one-rank ensemble."""
    import torch.multiprocessing as mp

    from mcmc_colorer_tpu_torch.parallel.chains import EnsembleMCMCColorer
    from mcmc_colorer_tpu_torch.parallel.mesh import make_mesh
    from mcmc_colorer_tpu_torch.parallel.sharded import ShardedMCMCColorer

    g = er20k()
    p = params_of(g.max_degree)
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "out")
        mesh = make_mesh(1, 1)
        c = ShardedMCMCColorer(g, p, mesh, n_chains=2, backend="pallas")
        want = {(2, 1): (sharded_digest(c.run(seed=5)), chain_colors(c, 5))}
        want[(1, 2)] = want["resume"] = want[(2, 1)]
        c.save_checkpoint(c._run_sharded_segment(c.init_state(5), 2), f"{out}.ckpt.npz")
        s = ShardedMCMCColorer(None, params_of(0), mesh, n_chains=8, resident_spec=(N, P, 0))
        want["strips"] = sharded_digest(s.run(seed=5))
        want["ensemble"] = ensemble_digest(
            EnsembleMCMCColorer(g, p, 8, backend="pallas", device=card).run(seed=5))
        t0 = time.perf_counter()
        ctx = mp.start_processes(_gloo_rank, args=(2, free_port(), out, 5), nprocs=2,
                                 join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=1.0):
                assert time.perf_counter() - t0 < DEADLINE_S, "the ranks outlived their deadline"
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        for r in range(2):
            with open(f"{out}.{r}", "rb") as f:
                got = pickle.load(f)
            for key, (dig, chains) in got.items():
                if key in ("strips", "ensemble"):
                    assert dig == want[key], (r, key)
                    continue
                assert dig == want[key][0], (r, key)
                assert chains is None or np.array_equal(chains, want[key][1]), (r, key)


LOG_FIELDS = ("Nodes:", "Edges:", "Max deg:", "Edge probability", "Seed:", "Repetition:",
              "Execution time:", "Iteration performed:", "Max iteration reached:",
              "Color histogram:", "Number of colors:", "Used colors:", "Color ratio:",
              "Average number of nodes for each color:", "Variance:", "StD:", "BalancingIndex")


def cli(args, n, tags, launcher=()):
    """The port's CLI in a subprocess, its standard input from /dev/null:
    exit 0, a log a tag with the reference's field names, a colour file a
    log of ``n`` lines, every run VALID.  Returns (the process, {colour
    file: its text})."""
    with tempfile.TemporaryDirectory() as td:
        proc = subprocess.run(
            [sys.executable, *launcher, "-m", "mcmc_colorer_tpu_torch.cli", *args,
             "--outDir", td],
            cwd=ROOT, capture_output=True, text=True, timeout=600, stdin=subprocess.DEVNULL)
        assert proc.returncode == 0, f"{args}: {proc.stderr[-4000:]}"
        files = sorted(os.listdir(td))
        logs = [f for f in files if f.endswith(".log")]
        assert {f.split("-")[-2] for f in logs} == set(tags), logs
        for f in logs:
            text = Path(td, f).read_text()
            assert all(k in text for k in LOG_FIELDS), f
            assert len(Path(td, f[:-4] + "-colors.txt").read_text().splitlines()) == n
        colors = {f: Path(td, f).read_text() for f in files if f.endswith("-colors.txt")}
    runs = [ln for ln in proc.stdout.splitlines() if " rep 0: " in ln]
    assert len(runs) == len(tags) and all("VALID" in x for x in runs), runs
    return proc, colors


def _torchrun():
    return ("-m", "torch.distributed.run", "--nproc-per-node", "2", "--master-addr",
            "127.0.0.1", "--master-port", str(free_port()))


def _cli_colorers():
    sim = ["--simulate", "0.01", "-n", "20000", "--tailcut", "--check", "--seed", "5"]
    cli(sim + ["--mcmcgpu", "--lubygpu", "--grdffgpu", "--vffgpu"], N,
        ("MCMC_GPU", "LUBY", "GFF", "VFF"))
    cli(sim + ["--resident", "--mcmcgpu", "--lubygpu"], N, ("MCMC_GPU", "LUBY"))
    cli(["--simulate", "0.01", "-n", "2000", "--mcmccpu", "--tailcut", "--check", "--seed",
         "5"], 2000, ("MCMC_CPU",))
    cli(sim + ["--mcmcgpu", "--active"], N, ("MCMC_GPU",))
    cli(sim + ["--resident", "--mcmcgpu", "--active"], N, ("MCMC_GPU",))
    cli(sim + ["--mcmcgpu", "--lubygpu", "--backend", "packed"], N, ("MCMC_GPU", "LUBY"))
    for active in ([], ["--active"]):
        cli(["--simulate", "0.001", "-n", "20000", "--layout", "bucketed", "--mcmcgpu",
             "--grdffgpu", "--vffgpu", "--lubygpu", "--tailcut", "--check", "--seed", "5",
             *active], N, ("MCMC_GPU", "LUBY", "GFF", "VFF"))


def _cli_chains():
    base = ["--simulate", "0.01", "-n", "20000", "--mcmcgpu", "--tailcut", "--check", "--seed",
            "5"]
    cli(base + ["--chains", "4"], N, ("MCMC_GPU",))
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "resident.npz")
        _, first = cli(base + ["--resident", "--chains", "4", "--ckpt", ck], N, ("MCMC_GPU",))
        assert os.path.exists(ck)
        _, again = cli(base + ["--resident", "--chains", "4", "--resume", ck], N, ("MCMC_GPU",))
        assert first == again
    cli(base + ["--dbg"], N, ("MCMC_GPU",))
    proc, _ = cli(base + ["-v", "1"], N, ("MCMC_GPU",))
    assert any("Max Free Colors: " in ln for ln in proc.stderr.splitlines())


def _cli_sharded():
    base = ["--simulate", "0.01", "-n", "20000", "--mcmcgpu", "--tailcut", "--check", "--seed",
            "5"]
    cli(base + ["--active", "--chains", "4"], N, ("MCMC_GPU",))
    cli(base + ["--active", "--chains", "4", "--anneal"], N, ("MCMC_GPU",))


def _cli_meshes():
    base = ["--simulate", "0.01", "-n", "20000", "--mcmcgpu", "--tailcut", "--check", "--seed",
            "5"]
    cli(base + ["--mesh-shards", "2"], N, ("MCMC_GPU",), launcher=_torchrun())
    cli(base + ["--resident", "--mesh-shards", "2"], N, ("MCMC_GPU",), launcher=_torchrun())
    cli(base + ["--backend", "packed", "--mesh-shards", "1"], N, ("MCMC_GPU",))


def case_cli(card):
    """The CLI as a user runs it, in four lanes of subprocesses (each call
    pays its imports and the card's start; a lane's calls run in order):
    the four device colourers, the resident MCMC and Luby, the host chain,
    the frontier chain (also resident), the packed backend, the bucketed
    layout (also with the frontier); ``--chains``, ``--resident --chains
    --ckpt`` then ``--resume`` (the same colours), ``--dbg`` with no input,
    ``-v 1`` (TRACE lines); ``--active --chains`` (also ``--anneal``); and
    under torchrun ``--mesh-shards 2`` (also resident), ``--backend packed
    --mesh-shards 1``."""
    with ThreadPoolExecutor(4) as pool:
        for f in [pool.submit(fn) for fn in (_cli_colorers, _cli_chains, _cli_sharded,
                                             _cli_meshes)]:
            f.result()


def case_scripts(card):
    """The baseline script's configs 1, 2 and 5 at full size on the card
    (config 5: 64 chains, their batched K2 launches equal to one launch a
    chain), the whole script with ``--small`` in a subprocess, every run
    valid; ``validate_stats`` (its four checks) and two ``validate_matrix``
    cells (their checks and the variants' separation)."""
    from mcmc_colorer_tpu_torch.scripts import run_baseline_configs as rbc
    from mcmc_colorer_tpu_torch.scripts import validate_matrix as vm
    from mcmc_colorer_tpu_torch.scripts import validate_stats as vs

    assert rbc.config1(False, card)["config1_sequential"]["valid"] is True
    assert rbc.config2(False, card)["config2_luby"]["valid"] is True
    with launches() as n, HeldLaunches() as held:
        e5 = rbc.config5(False, card)["config5_ensemble"]
    assert e5["valid"] is True and e5["best_conflicts"] == 0 and e5["chains"] == 64
    assert n["K2"] > 0 and "K2" in held.check()
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "small.json")
        proc = subprocess.run(
            [sys.executable, "-m", "mcmc_colorer_tpu_torch.scripts.run_baseline_configs",
             "--small", "--out", out], cwd=ROOT, capture_output=True, text=True, timeout=600,
            stdin=subprocess.DEVNULL)
        assert proc.returncode == 0, proc.stderr[-3000:]
        small = json.loads(Path(out).read_text())
    valids = [e["valid"] for k, e in small.items() if k.startswith("config") and "valid" in e]
    valids += [e["valid"] for e in small["config3_ratio_sweep"]["sweep"].values()]
    assert len(valids) == 8 and all(v is True for v in valids), valids
    with HeldLaunches() as held:
        with launches() as n:
            rep = vs.validate(device=card)
        assert all(rep["checks"].values()) and n["K2"] > 0, rep["checks"]
        for p_edge, ratio in ((0.005, 1.0), (0.04, 2.0)):
            with launches() as n:
                cell = vm.matrix_cell(erdos_renyi(4000, p_edge, seed=777), p_edge, ratio, 3,
                                      card)
            assert all(cell["checks"].values()) and cell["variant_effect"]["separates"]
            assert n["K2"] > 0 and n["K3"] > 0
    assert held.check() == ["K2", "K3"]


def case_analysis(card):
    """A batch of logs written by the CLI in a subprocess (the host chain,
    the device chain and Luby at ER(2k and 4k, 0.005), twice each; the
    device chain at ER(20k, 0.005) at three palettes), read back by
    ``mcmc_colorer_tpu_torch.analysis``: the records by tag and size, each
    histogram against its colour file and the log's balance index, both
    speedup kinds at both sizes, the var-col surface's three cells, the
    JSON round trip, and the plots drawn or skipped where matplotlib is
    missing."""
    from mcmc_colorer_tpu_torch import analysis
    from mcmc_colorer_tpu_torch.analysis import log_parser

    sizes, ratios = (2000, 4000), (1.0, 2.0, 4.0)
    with tempfile.TemporaryDirectory() as td:
        base = ["--simulate", "0.005", "--tailcut", "--check", "--seed", "5", "--quiet",
                "--outDir", td]
        calls = [["-n", str(n), "--mcmccpu", "--mcmcgpu", "--lubygpu", "--repet", "2"]
                 for n in sizes]
        calls += [["-n", str(N), "-r", str(r), "--mcmcgpu"] for r in ratios]
        for args in calls:
            subprocess.run([sys.executable, "-m", "mcmc_colorer_tpu_torch.cli", *base, *args],
                           cwd=ROOT, check=True, timeout=600, stdin=subprocess.DEVNULL)
        res = analysis.parse_results_dir(td)
        assert set(res) == {"MCMC_CPU", "MCMC_GPU", "LUBY"}
        want = {(t, n): 2 for t in res for n in sizes}
        want[("MCMC_GPU", N)] = len(ratios)
        got = {}
        for tag, runs in res.items():
            for r in runs:
                got[(tag, r["nodes"])] = got.get((tag, r["nodes"]), 0) + 1
                hist = r["histogram"]
                colors = np.loadtxt(r["path"][:-4] + "-colors.txt", dtype=np.int64)[:, 1]
                assert sum(hist) == r["nodes"] == len(colors)
                assert np.bincount(colors, minlength=len(hist)).tolist() == hist
                bi = analysis.balance_index(hist, r["nodes"], r["prob"], r["n_colors"])
                assert abs(bi - r["balancing_index"]) <= 1e-9
        assert got == want
        for table in (analysis.speedups(res), analysis.per_iteration_speedups(res)):
            for pair in ("MCMC_CPU/MCMC_GPU", "LUBY/MCMC_GPU"):
                row = table.get(pair, {})
                assert sorted(row) == list(sizes)
                assert all(np.isfinite(v) and v > 0 for v in row.values())
        assert sorted(log_parser.var_col_surface(res)) == [(r, 0.005) for r in ratios]
        out = os.path.join(td, "results.json")
        saved = log_parser.save_results_json(td, out)
        assert json.loads(Path(out).read_text()) == saved == res
        log_parser.plot_speedup(res, os.path.join(td, "speedup.png"))
        log_parser.plot_speedup(res, os.path.join(td, "speedup_iter.png"), per_iteration=True)
        log_parser.plot_var_col_3d(res, os.path.join(td, "varcol.png"))
        log_parser.plot_balance_index(res, os.path.join(td, "bi.png"), prob=0.005)


CASES = {f.__name__[5:]: f for f in (
    case_resident, case_ell_packed_hastings, case_greedy_vff, case_luby, case_frontier_chains,
    case_config4, case_stepped, case_ensembles, case_resident_ensemble, case_sharded,
    case_strips)}
SLOW = {f.__name__[5:]: f for f in (
    case_main_path, case_config3, case_ba1m, case_two_ranks, case_cli, case_scripts,
    case_analysis)}


@pytest.mark.card
@pytest.mark.parametrize("case", [*CASES, *(pytest.param(k, marks=pytest.mark.slow)
                                            for k in SLOW)])
def test_colorer_path(card, case):
    {**CASES, **SLOW}[case](card)
