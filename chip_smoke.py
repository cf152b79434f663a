#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mcmc_colorer_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every kernel from ``csrc/`` (one nvcc per source, all started
together, into the git-ignored ``build/kernels/``) and holds each against
its plain PyTorch version on the card: K1 (bit-packed NC) exactly, K3
(masked first fit over the neighbours' colours, which it gathers itself)
exactly, K2 (the resample sweep, which also gathers the colours itself)
with exact conflict counts and sampled colours that may differ only at
CDF-boundary vertices, in both of its regimes (the colour vector staged
in shared memory, and read from L2).  Then it drives
both main paths through the library surface, where every colorer runs on
the card by default:

- slice 1, the resident path: the hash generator (kernel K6, the packed A
  and its degrees in one launch) word for word against the numpy oracle,
  then at the bench shape ER(100k, 0.01) bit for bit against its plain
  version on the card and timed beside it (phase 3); ER(n=100k, p=0.01)
  with balance-dynamic proposals and the tailcut, checked against the
  host's C++ re-derivation, and a tight-palette run;
- slice 2, the ELL path: BASELINE config 3, ER(n=1M, p=0.001) from the
  native sampler at numColRatio 1, 2 and 4, plus GreedyFF; config 4, a
  BA(50k, 8) graph written in the network-repository layout, converted,
  loaded by the native importer and coloured; and the K2 chain beside the
  K1 chain on the ER(100k, 0.01) graph of slice 1 (K2 staged there, L2
  at config 3; one launch a sweep on both);
- config 3 with no host graph, kernel K5: phase 41 builds the hash
  G(10^6, 0.001) of ``ops/hashgen.py`` (graph seed 0, the benchmark's
  ``er1m_p001``) as ``HashGraph``'s flat ELL on the card, two K5 launches
  (count, fill); holds sampled bands of its rows, at full n and into the
  phantom rows, exactly against the plain version's same rows on the
  card; times the count and the fill beside that plain version and the
  least time of the pair tests; and runs ``MCMCColorer`` over it at
  numColRatio 1, 2 and 4 (K2 and K3 counted on the config-3 rows, K5 not
  run again), each colouring's conflicts counted on the card over K5's
  rows;
- slice 4, the other colorers and the CLI: at config 3 the frontier
  GreedyFF (its colours must equal the full loop's) and VFF, full and
  frontier (K3 with allow and cur), each also on K3's plain version: all
  four must end phase 2 in the same colours, which the livelock fallback
  would otherwise hide, and K3 is held exactly at VFF's two call sites
  with phase 2's own allow and cur; on the ER(100k, 0.01) graph Luby's
  gather and frontier loops and resident Luby on the hash graph (K1),
  which must equal the gather loop fed the same draws, and K1 held
  exactly and timed at resident Luby's two shapes; then the CLI as a
  user runs it, in subprocesses: the four device colorers on a simulated
  ER(100k, 0.01), the resident path with MCMC and Luby sharing one
  adjacency, and --mcmccpu on ER(2000, 0.01), each with --check, every
  log carrying the reference's field names;
- slice 6, the frontier MCMC chain and the packed backend over a host
  graph: at config 3 the frontier chain (``ActiveMCMCColorer``: K2 once a
  full sweep and once a frontier iteration, with ``self_ids``; its kept
  cnt a fresh count at the chain's end) beside phase 9's full chain; on
  the ER(100k, 0.01) hash graph the resident frontier (the README's
  command: K1 sweeps and cnt, K2 on rows unpacked from A, which must
  equal the host ELL's sorted rows); on its host graph
  ``MCMCColorer(backend="packed")``, whose A built from the ELL must equal
  the resident A on the real rows; K2 with ``self_ids`` held at each
  (palette, cap) both frontiers ran, in both regimes, K1 at the host
  graph's shape; one host read a frontier iteration, under torch's sync
  debug mode; short Hastings runs over K2 and over K1 and an ``xla``
  run, each valid; and the CLI's ``--mcmcgpu --active`` (also
  ``--resident``) and ``--backend packed`` at ER(20k, 0.01);
- slice 7, the degree-bucketed layout: at config 4 (phase 10's graph)
  every device colorer with ``layout="bucketed"`` beside the flat layout
  (MCMCColorer, also with Hastings, ActiveMCMCColorer, GreedyFF, VFF and
  Luby, full and frontier), K2 launched exactly once a degree class a
  sweep, GreedyFF's colours equal with K3 and with its plain version and
  full and frontier; BA(1M, 8) from the native sampler through the
  bucketed MCMCColorer and GreedyFF; every K2 and K3 shape these runs
  launched held against the plain version on the inputs the run gave it,
  and timed; and the CLI's ``--layout bucketed`` (also ``--active``);
- slice 8, stepped chains, ensembles, checkpoints and the free-colour
  TRACE, with K1, K2 and K3 taking a chain axis: phase 22 the stepped
  chain (``SteppedMCMC``) on the ER(100k, 0.01) host graph at numColRatio
  4, checkpointed in segments of 4, a half-way checkpoint resumed by a
  fresh instance (equal to the uninterrupted run), ``inspect`` on the
  card equal to a CPU copy, the debugger's ε edit reaching the next
  segment, and ``MCMCColorer`` under ``MCMC_COLORER_TRACE=1`` (the
  untraced colouring, one TRACE line a segment); phase 23
  ``EnsembleMCMCColorer`` with 8 chains on that graph and 4 bucketed at
  config 4, each chain equal to a one-chain run fed its source; phase 24
  the resident ensemble (4 chains, checkpoint at 2 iterations resumed
  equal) and the ``matmul`` ensemble, and the resident TRACE; every
  batched K1, K2 and K3 launch of these runs held against its plain
  version and against one launch a chain, exactly (samples under the
  CDF-boundary rule), and timed beside them by CUDA events and device
  time; phase 25 the CLI's ``--chains``, ``--resident --chains --ckpt``
  then ``--resume``, ``--dbg`` and ``-v 1``;
- slice 9, the sharded ensemble over ``torch.distributed``: phase 26
  ``ShardedMCMCColorer`` on a 1x1 mesh under a one-rank NCCL group at
  ER(100k, 0.01) with 8 chains (full sweeps, the frontier, Hastings,
  pooled annealing, and a run stopped after 2 sweeps for the rank-space
  tailcut), beside the 8-chain ensemble in the same call; phase 27 config
  3 at 2 chains (K2 in L2 with a million rows on the rank); phase 28 a
  segmented run and a resumed one, each equal to the uninterrupted run;
  phase 29 two gloo ranks spawned on the one card, at (2, 1) and (1, 2)
  each equal to the 1x1 run (a chain's full sweeps draw alike on every
  geometry), (2, 1) also resumed from phase 28's 1x1 checkpoint, and the
  CLI under ``torchrun --nproc-per-node 2 ... --mesh-shards 2``; phase 30
  K2 and K3 on shard 1's rows of a (1, 2) layout, at its row offset,
  against their plain versions; phase 31 the CLI's ``--active --chains
  4``, also with ``--anneal``.  Every K2 and K3 launch of phases 26 and
  27 is recorded by shape, held against the plain version and timed;
- slice 10, the sharded colorer's adjacency strips, K1 at ``_strip_nc``:
  phase 32 ``ShardedMCMCColorer(None, resident_spec=(100k, 0.01, 0))`` on
  the 1x1 mesh with 8 chains at nCol 1150 (its strip phase 4's cached A):
  full sweeps, the frontier (rows unpacked from the strip, K2), Hastings
  and a run left to the strip tailcut, each valid against phase 4's C++
  re-derivation; phase 33 ``backend="matmul"`` on phase 11's host graph
  (its strips built from the ELL), whose first sweep equals the
  ``pallas`` run's on the same sources but at CDF-boundary rows, and a
  valid run; phase 34 two gloo ranks on the one card at (1, 2) on the
  hash strips, each generating its own, equal to phase 32's 1x1 run, and
  K1 held at a rank's strip shape; phase 35 the CLI's ``--resident
  --mesh-shards 2 --check`` under torchrun and ``--backend packed
  --mesh-shards 1``.  Every K1 launch of phases 32 and 33 is recorded by
  strip and colours shape (``_K1Shapes``), held exactly against
  ``packed_nc_reference`` on the run's own inputs and timed;
- slice 11, the baseline and validation scripts and the ensemble over a
  mesh (the hash host graphs are now certified simple, so phase 18
  skips the packed A's completeness check): phase 36
  ``scripts/run_baseline_configs``'s configs 1, 2 and 5 at full size,
  each valid (config 5: 64 chains on ER(20k, 0.002), its batched K2
  launches held against the plain version), its config-3 and config-4
  constants equal to this script's, the whole script with ``--small`` in
  a subprocess, and ``estimate_run_bytes`` of config 3 beside phase 9's
  chain peak; phase 37 ``scripts/validate_stats`` in full (its four
  checks) and two ``validate_matrix`` cells (checks and the variants'
  separation), their K2 and K3 launches held; phase 38
  ``EnsembleMCMCColorer(mesh=)`` over two gloo ranks on the one card at
  (2, 1), each rank equal to phase 23's one-rank 8-chain ensemble;
- slice 12, the offline analysis: phase 39 the CLI, in this process,
  writes logs of the host chain, the device chain and Luby at ER(2k and
  4k, 0.005), twice each, and of the device chain at ER(20k, 0.005) with
  three palettes; ``mcmc_colorer_tpu_torch.analysis`` reads them with no
  jax module loaded and every record is checked (histogram against its
  colour file, balance index against the log's), the speedups at both
  sizes (printed beside the card's name and power limit), the var-col
  surface's three cells, the JSON round trip, and the plots, drawn or
  skipped where matplotlib is missing; the batch's K2 and K3 launches
  held against the plain versions;
- the proposal over NC, kernel K4: phase 40 holds it against its plain
  version on NC from K1 over phase 4's ER(100k, 0.01) graph, at the
  resident chain's palettes (nCol = max degree / 1, 2, 4, one chain) and
  at the sharded strips' [8, 100,352, 1,152], with the same uniforms:
  conf2 exact, the samples equal but at CDF-boundary rows, Σ log qstar
  within 1e-4 (relative) where they agree, each shape timed beside its
  bound; the kernels line weights the shapes by the launches of the main
  paths that run them, phase 4's chain (one launch a sweep) and phase
  32's hash strips.

The CLI phases (15, 25, 31 and 35) run last, as four concurrent lanes of
subprocesses (``phase_clis``), each lane's calls in order.

Every colouring is checked with ``check_coloring``, but phase 41's,
which are checked on the card against K5's rows (the host graph at that
size takes a minute to enumerate).  Any failed check
raises, so the exit code is non-zero.  Without CUDA, or outside a
checkout, it exits non-zero before printing any result.

The last line of standard output is one JSON object naming the device;
the line before it is the card's name and power limit; the one before
that holds the kernels' launch counts, errors and times, each beside its
bound: the least time the card could take for the same work, the larger
of the bytes it must move (each input read once, each output written
once) over the memory rate and its operations over their peak rate.
K1 runs at four shapes on the main paths (and at the strip shapes of
phases 32-34, its rows under ``shapes``), K2 at two sweep shapes, at
each (palette, cap) of the two frontiers and at each shape of the runs of
phases 20 and 21, K3 at the config-3 band and at each shape of phases 20
and 21; their times and bounds are means weighted by the launches at
each, listed under ``shapes``.  K5's entry is one build at config 3 (its
count and fill launches, each under ``shapes``): ``ms`` the two summed,
``plain_ms`` the plain version's time over phase 41's sampled rows scaled
to n.  K6's entry is one build of the bench graph's A and degrees
(phase 3), its bound by ``colorbench/roofline/k5.py``'s rule at that n;
its ``launches`` are the main path's (phase 4, its graph built anew:
exactly 1).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the three shapes of tests/test_matmul_backend.py:test_packed_nc_pallas_matches_dense,
# and a palette wide enough (8064 padded colours) that K1 takes fewer rows
# per block and more than 48 KB of shared memory
K1_SHAPES = [(1500, 0.05, 150), (4700, 0.01, 1100), (640, 0.3, 64), (3000, 0.5, 8000)]
BENCH_N, BENCH_P = 100_000, 0.01
# K1 is timed at the chain's palette on the bench graph (max degree 1150)
K1_BENCH_COLORS = 1152
TIMED_RUNS = 10
# BASELINE.md config 3 (scripts/run_baseline_configs.py:140-194) and
# config 4 (:196-240)
CONFIG3_N, CONFIG3_P, CONFIG3_SEED, CONFIG3_RATIOS = 1_000_000, 0.001, 3, (1.0, 2.0, 4.0)
CONFIG4_N, CONFIG4_M, CONFIG4_SEED = 50_000, 8, 4
# phase 41: config 3 as the hash graph of ops/hashgen.py (the benchmark's
# er1m_p001 graph, seed 0), its ELL built by K5; rows of each sampled band
HASH3_GRAPH_SEED, HASH3_BAND_ROWS = 0, 128
CONFIG3_RUN_SEED, CONFIG4_RUN_SEED = 31, 41  # the chains' seeds (:178, :223)
# phase 21: config 4's generator at a million vertices (max degree 4677)
BA1M_N = 1_000_000
# the frontier chains' palettes: ratio 1, and a tighter one whose chain
# leaves the frontier more work
CONFIG3_FRONTIER_RATIOS = (1.0, 4.0)
# The resident chain tests its switch only between budgets of 4 sweeps,
# and its conflicts fall 10-20x a sweep near the end (on the H100 at ε =
# 1e-8 it reached the tailcut's 50 within the budget, at ratio 1, and 0
# conflicts at ratio 2 without the tailcut), so at the reference's ε it
# may run no frontier iteration.  At ε = 1e-5 ~1,150 vertices a sweep
# take a random colour, which holds the full chain at some hundreds of
# conflicts; the frontier, at most one such flip an iteration, removes
# them: the regime it is built for
RESIDENT_FRONTIER_EPS = (1e-8, 1e-5)
# K2's sampled colour may differ from the plain version's only where the
# uniform lies within BOUNDARY_RTOL (relative) of the plain cdf at the
# plain colour or the one before it, at no more than this share of rows
BOUNDARY_RTOL, BOUNDARY_MAX_FRACTION = 1e-5, 1e-3
# the H100 SXM's device memory rate and its float32 rate outside the
# tensor cores (NVIDIA's data sheet); int32 adds and logic ops issue at
# half the float32 rate (64 of an SM's 128 lanes a clock)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = FP32_OPS_PER_S / 2


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# about a millisecond of the card's clock: longer than the host takes to
# queue one K4 call's launches
QUEUE_SPIN_CYCLES = 2_000_000


def _median_ms(fn, runs: int = TIMED_RUNS, queued: bool = False) -> float:
    """Median CUDA-event time of ``fn`` over ``runs`` calls, after one warm-up.
    ``queued``: the stream first spins on the card (``torch.cuda._sleep``)
    while the host queues ``fn``'s launches, so the time is the card's
    alone, without the host's time between the events and the launches."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(n_bytes: int, ops: int, ops_per_s: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rate."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _gathered_bytes(neigh, colors) -> int:
    """The colour bytes a gather of ``colors`` at the ids ``neigh`` must
    read: each colour once, and no more colours than there are real
    neighbour slots (ids below ``len(colors)``; the rest are padding)."""
    slots = int((neigh < colors.shape[0]).sum())
    return min(colors.shape[0], slots) * colors.element_size()


def _random_colors(n: int, n_pad: int, n_colors: int, gen, device):
    """Colours in [0, n_colors) for real vertices, -1 for phantoms."""
    import torch

    c = torch.randint(0, n_colors, (n_pad,), generator=gen, device=device,
                      dtype=torch.int32)
    c[n:] = -1
    return c


def phase_k1(device, shapes, bench_n_pad=None, bench_colors=K1_BENCH_COLORS, seed=5):
    """K1 against its plain version, exactly, at ``shapes``, on rows of
    2**16 set bits (the kernel's 32-bit path) and (if given) at the bench
    shape, where both are also timed.  Returns (max_abs_err, kernel_ms,
    plain_ms, bytes moved, set bits) at the bench shape."""
    import torch

    from mcmc_colorer_tpu_torch.ops import packed_nc as k1
    from mcmc_colorer_tpu_torch.ops.dense_adj import n_col_pad_of
    from mcmc_colorer_tpu_torch.ops.hashgen import degrees_from_packed, er_packed_on_device

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    err = 0
    for n, p, ncol in shapes:
        n_pad = _round_up(n, 128)
        adj = er_packed_on_device(n, p, 2, n_pad, row_chunk=128, device=device)
        colors = _random_colors(n, n_pad, ncol, gen, device)
        got = k1.packed_nc(adj, colors, n_col_pad_of(ncol))
        want = k1.packed_nc_reference(adj, colors, n_col_pad_of(ncol))
        e = int((got - want).abs().max())
        _require(e == 0, f"K1 differs from its plain version at {(n, p, ncol)}: {e}")
        err = max(err, e)
        print(f"phase 2 K1 n={n} p={p} n_col_pad={n_col_pad_of(ncol)}: exact")
    wide = torch.randint(-2**31, 2**31 - 1, (64, 2048), generator=gen, device=device,
                         dtype=torch.int32)
    wide[::2] = -1  # every bit set: 65,536 a row
    cw = torch.randint(-1, 8, (2048 * 32,), generator=gen, device=device, dtype=torch.int32)
    e = int((k1.packed_nc(wide, cw, 128) - k1.packed_nc_reference(wide, cw, 128)).abs().max())
    _require(e == 0, f"K1 differs from its plain version on rows of 65,536 set bits: {e}")
    print("phase 2 K1 rows of 65,536 set bits (the 32-bit path): exact")
    if bench_n_pad is None:
        return err, None, None, None, None
    # the bench shape: the hash graph of the bench density (another graph
    # seed than the main path's, which generates its own)
    adj = er_packed_on_device(BENCH_N, BENCH_P, 1, bench_n_pad, device=device)
    colors = _random_colors(BENCH_N, bench_n_pad, bench_colors, gen, device)
    ncp = n_col_pad_of(bench_colors)
    got = k1.packed_nc_cuda(adj, colors, ncp)
    want = k1.packed_nc_reference(adj, colors, ncp)
    e = int((got - want).abs().max())
    _require(e == 0, f"K1 differs from its plain version at the bench shape: {e}")
    del got, want
    kernel_ms = _median_ms(lambda: k1.packed_nc_cuda(adj, colors, ncp))
    plain_ms = _median_ms(lambda: k1.packed_nc_reference(adj, colors, ncp))
    set_bits = int(degrees_from_packed(adj).sum())
    n_bytes = _nbytes(adj, colors) + adj.shape[0] * ncp * 4
    print(
        f"phase 2 K1 bench shape n_pad={bench_n_pad} words={adj.shape[1]} "
        f"n_col_pad={ncp} set_bits={set_bits}: exact; "
        f"kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"(median of {TIMED_RUNS}, CUDA events); moves {n_bytes} bytes"
    )
    return max(err, e), kernel_ms, plain_ms, n_bytes, set_bits


def _pack_edges_host(edges, n_pad: int):
    """Oracle: upper-triangle edges -> [n_pad, words] uint32, both directions."""
    import numpy as np

    from mcmc_colorer_tpu_torch.ops.dense_adj import packed_adj_words, packed_bit_coords

    words = packed_adj_words(n_pad)
    u = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int64)
    v = np.concatenate([edges[:, 1], edges[:, 0]]).astype(np.int64)
    word, bit = packed_bit_coords(v)
    out = np.zeros((n_pad, words), np.uint32)
    np.bitwise_or.at(out, (u, word), np.uint32(1) << bit.astype(np.uint32))
    return out


def phase_hash(device, n=5000, p=0.01, seed=11):
    """Hash generator on ``device`` (K6, one launch for A and its degrees)
    against the numpy oracle, word for word."""
    import numpy as np

    from mcmc_colorer_tpu_torch.interop import adjacency_to_jax
    from mcmc_colorer_tpu_torch.ops import hash_packed as k6
    from mcmc_colorer_tpu_torch.ops.hashgen import (
        degrees_from_packed, er_packed_and_degrees, hash_edges_reference,
    )

    n_pad = _round_up(n, 2048)
    before = k6.launches
    adj, k6_deg = er_packed_and_degrees(n, p, seed, n_pad, device=device)
    _require(k6.launches == before + 1, f"K6 launched {k6.launches - before} times, not once")
    edges = hash_edges_reference(n, p, seed)
    want = _pack_edges_host(edges, n_pad)
    got = adjacency_to_jax(adj)
    _require(np.array_equal(got, want), f"hash words differ at n={n}")
    deg = degrees_from_packed(adj).cpu().numpy()[:n]
    want_deg = np.bincount(edges.ravel(), minlength=n)
    _require(np.array_equal(deg, want_deg), "degrees differ from the oracle")
    k6_deg = k6_deg.cpu().numpy()
    _require(np.array_equal(k6_deg[:n], want_deg) and not k6_deg[n:].any(),
             "K6's degrees differ from the oracle")
    print(
        f"phase 3 hash n={n} n_pad={n_pad} words={adj.shape[1]} "
        f"edges={edges.shape[0]}: K6's words and degrees exact (1 launch)"
    )


def phase_k6(device, n=BENCH_N, p=BENCH_P, seed=1):
    """K6 at the bench shape: the whole A and its degrees of ER(100k,
    0.01) in one launch, bit for bit against the plain version on the
    card, both timed (CUDA events), beside the least time of the work by
    ``colorbench/roofline/k5.py``'s rule (8 int32 operations an unordered
    pair; A and the degrees written once).  Returns the kernels line's K6
    entry, whose ``launches`` phase 4 sets to the main path's own count."""
    import torch

    from mcmc_colorer_tpu_torch.ops import hash_packed as k6
    from mcmc_colorer_tpu_torch.ops.hashgen import er_packed_and_degrees, er_packed_plain

    n_pad = _round_up(n, 2048)
    before = k6.launches
    adj, deg = er_packed_and_degrees(n, p, seed, n_pad, device=device)
    launches = k6.launches - before
    _require(launches == 1, f"K6 launched {launches} times for one build, not once")
    want, want_deg = er_packed_plain(n, p, seed, n_pad, device=device)
    _require(torch.equal(adj, want) and torch.equal(deg, want_deg),
             f"K6 differs from its plain version at ER({n}, {p})")
    edges = int(want_deg.sum()) // 2
    del want, want_deg
    kernel_ms = _median_ms(lambda: er_packed_and_degrees(n, p, seed, n_pad, device=device))
    plain_ms = _median_ms(lambda: er_packed_plain(n, p, seed, n_pad, device=device), runs=3)
    n_bytes = _nbytes(adj, deg)
    ops = 8 * (n * (n - 1) // 2)
    bound_ms, bound_by = _bound(n_bytes, ops, INT32_OPS_PER_S)
    print(f"phase 3 K6 ER({n}, {p}) A [{n_pad}, {adj.shape[1]}] and degrees ({edges} edges): "
          f"exact against the plain version on the card; kernel {kernel_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms (medians, CUDA events); bound {bound_ms:.3f} ms ({bound_by}), "
          f"{bound_ms / kernel_ms:.2%} of it")
    return {
        "name": "hash_packed",
        "route": "cuda",
        "source": "mcmc_colorer_tpu_torch/csrc/hash_packed.cu",
        "replaces": None,  # the JAX package generates the packed A in jnp ops
        "launches": launches,
        "max_abs_err": 0,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_share": bound_ms / kernel_ms,
        "library_ms": None,
        "shapes": [{"shape": f"A [{n_pad}, {adj.shape[1]}] and degrees", "launches": launches,
                    "ms": kernel_ms, "bytes": n_bytes, "ops": ops, "bound_ms": bound_ms,
                    "bound_by": bound_by}],
    }


def phase_main(device, n=BENCH_N, p=BENCH_P, graph_seed=0, seed=5):
    """The main path, once, through the library surface, its graph built
    anew (the cache emptied first); returns (coloring, colorer, K1
    launches during it, the host graph, K4 launches during it, K6
    launches during it)."""
    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.models.base import check_coloring
    from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer
    from mcmc_colorer_tpu_torch.ops import hash_packed as k6
    from mcmc_colorer_tpu_torch.ops import packed_nc as k1
    from mcmc_colorer_tpu_torch.ops import propose_nc as k4
    from mcmc_colorer_tpu_torch.ops.hashgen import _PACKED_CACHE

    params = MCMCParams(n_colors=0, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    _PACKED_CACHE.clear()
    k1.launches = k4.launches = k6.launches = 0
    t0 = time.perf_counter()
    c = ResidentMCMCColorer(n, p, graph_seed=graph_seed, params=params, device=device)
    r = c.run(seed=seed)
    wall = time.perf_counter() - t0
    launches, launches4, launches6 = k1.launches, k4.launches, k6.launches
    x = r.extra
    print(
        f"phase 4 main ER({n}, {p}) n_colors={c.params.n_colors} "
        f"edges={c.n_edges} max_degree={c.max_degree}: "
        f"gen {x['gen_seconds']:.3f} s; iterations {r.iterations}, "
        f"sweeps {x['sweeps']}, tailcut rounds {x['tailcut_rounds']}; "
        f"chain {x['chain_seconds']:.3f} s, after chain {x['tailcut_seconds']:.3f} s, "
        f"run {r.duration_ms / 1e3:.3f} s, wall {wall:.3f} s; "
        f"{x['chain_seconds'] / max(x['sweeps'], 1) * 1e3:.3f} ms/sweep; "
        f"K1 launches {launches}, K4 launches {launches4}, K6 launches {launches6}"
    )
    _require(launches6 == 1,
             f"the main path launched K6 {launches6} times to build its graph, not once")
    _require(launches > 0, "the main path launched K1 no time")
    _require(launches4 == x["sweeps"] > 0,
             f"the main path launched K4 {launches4} times in {x['sweeps']} sweeps, not once "
             f"a sweep")
    t0 = time.perf_counter()
    g = c.host_graph()
    host_s = time.perf_counter() - t0
    _require(g.simple_certified, "the hash host graph is not certified simple")
    _require(g.n_edges == c.n_edges, f"edges: host {g.n_edges} vs device {c.n_edges}")
    _require(g.max_degree == c.max_degree, "max degree: host vs device differ")
    _require(r.colors.shape == (n,), f"colours shape {r.colors.shape}")
    _require(
        int(r.colors.min()) >= 0 and int(r.colors.max()) < c.params.n_colors,
        "colours outside the palette",
    )
    t0 = time.perf_counter()
    valid = check_coloring(g, r.colors)
    check_s = time.perf_counter() - t0
    _require(valid and x["final_conflicts"] == 0,
             f"invalid colouring: valid={valid} conflicts={x['final_conflicts']}")
    print(
        f"phase 4 check: host C++ re-derivation {host_s:.3f} s, "
        f"check {check_s:.3f} s: valid, 0 conflicts"
    )
    return r, c, launches, g, launches4, launches6


def phase_tight(device, n=20_000, p=0.01, graph_seed=3, seed=5):
    """Palette at max degree / 2: the tailcut must do real work."""
    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.models.base import check_coloring
    from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer

    c0 = ResidentMCMCColorer(n, p, graph_seed=graph_seed, device=device)
    params = MCMCParams(
        n_colors=max(4, c0.max_degree // 2),
        proposal=ProposalKind.BALANCE_DYNAMIC,
        tailcut=True,
        max_iterations=60,
    )
    c = ResidentMCMCColorer(n, p, graph_seed=graph_seed, params=params, device=device)
    r = c.run(seed=seed)
    x = r.extra
    valid = check_coloring(c.host_graph(), r.colors)
    print(
        f"phase 5 tight ER({n}, {p}) n_colors={params.n_colors}: iterations "
        f"{r.iterations}, tailcut rounds {x['tailcut_rounds']}, final conflicts "
        f"{x['final_conflicts']}, valid {valid}, run {r.duration_ms / 1e3:.3f} s"
    )
    _require(x["tailcut_rounds"] >= 1, "the tight palette took no tailcut round")
    _require(valid and x["final_conflicts"] == 0, "tight palette: invalid colouring")


def build_kernels():
    """Start every kernel's nvcc together; returns {name: (module, build)}."""
    from concurrent.futures import ThreadPoolExecutor

    from mcmc_colorer_tpu_torch.ops import firstfit as k3
    from mcmc_colorer_tpu_torch.ops import hash_ell as k5
    from mcmc_colorer_tpu_torch.ops import hash_packed as k6
    from mcmc_colorer_tpu_torch.ops import packed_nc as k1
    from mcmc_colorer_tpu_torch.ops import propose_nc as k4
    from mcmc_colorer_tpu_torch.ops import resample as k2

    mods = {"K1": k1, "K2": k2, "K3": k3, "K4": k4, "K5": k5, "K6": k6}
    with ThreadPoolExecutor(len(mods)) as pool:
        futs = {k: pool.submit(m.load_kernel) for k, m in mods.items()}
        return {k: (mods[k], f.result()) for k, f in futs.items()}


def _ptxas(built) -> str:
    return " | ".join(
        ln.strip() for ln in built.log.splitlines() if "registers" in ln or "smem" in ln
    )


def _real_colors(n: int, n_pad: int, n_colors: int, gen, device):
    """Colours in [0, n_colors) for real vertices, n_colors for phantoms."""
    c = _random_colors(n, n_pad, n_colors, gen, device)
    c[n:] = n_colors
    return c


def setup_config3(device):
    """BASELINE config 3's graph from the native sampler and its ELL on the
    card, built there from the CSR; returns (graph, ell, band rows)."""
    import torch

    from mcmc_colorer_tpu_torch.graph.container import degree_pad_for
    from mcmc_colorer_tpu_torch.graph.generate import erdos_renyi
    from mcmc_colorer_tpu_torch.models.mcmc import _fused_super_block, choose_block_size

    t0 = time.perf_counter()
    g = erdos_renyi(CONFIG3_N, CONFIG3_P, seed=CONFIG3_SEED)
    gen_s = time.perf_counter() - t0
    stats = {}
    t0 = time.perf_counter()
    ell = g.to_ell(
        pad_nodes_to=choose_block_size(g.n, g.max_degree),
        pad_degree_to=degree_pad_for(g, "pallas"),
        device=device, device_build=True, build_stats=stats,
    )
    torch.cuda.synchronize()
    ell_s = time.perf_counter() - t0
    sb = _fused_super_block(ell.n_pad, ell.d_pad)
    print(
        f"phase 9 setup: ER({CONFIG3_N}, {CONFIG3_P}) seed {CONFIG3_SEED}, native "
        f"sampler: n={g.n} m={g.n_edges} max_degree={g.max_degree}, gen {gen_s:.3f} s; "
        f"ELL [{ell.n_pad}, {ell.d_pad}] built on the card from the CSR "
        f"({stats['bands']} bands, {stats['upload_bytes']} bytes uploaded) {ell_s:.3f} s; "
        f"band rows {sb}"
    )
    return g, ell, sb


def _k3_check(k3, neighbors, colors, allow, n_colors, cur, label, phase=7):
    got = k3.first_fit_cuda(neighbors, colors, allow, n_colors, cur)
    want = k3.first_fit_plain(neighbors, colors, allow, n_colors, cur)
    err = int((got - want).abs().max()) if got.numel() else 0
    _require(err == 0, f"K3 differs from its plain version at {label}: {err}")
    print(f"phase {phase} K3 {label}: exact ({int((got >= 0).sum())} of {got.numel()} rows "
          f"found a colour)")
    return err


def phase_k3(device, ell3, sb):
    """K3 (neighbour ids in, colours gathered in the kernel) against its
    plain version (the gather, then first fit), exactly; timed at the
    config-3 band.  Returns (max_abs_err, kernel_ms, plain_ms, bytes
    moved, neighbour slots) at that band."""
    import torch

    from mcmc_colorer_tpu_torch.graph.generate import erdos_renyi
    from mcmc_colorer_tpu_torch.ops import firstfit as k3

    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    i32 = torch.int32
    # the shape of tests/test_pallas_firstfit.py:test_first_fit_kernel_matches_xla
    g = erdos_renyi(500, 0.05, seed=3)
    ell = g.to_ell(pad_nodes_to=128, device=device)
    ncol = g.max_degree + 1
    colors = torch.randint(-1, ncol, (ell.n_pad,), generator=gen, device=device, dtype=i32)
    allow = torch.ones((ncol,), dtype=i32, device=device)
    allow[::7] = 0
    err = _k3_check(k3, ell.neighbors, colors, allow, ncol, colors,
                    f"ER(500, 0.05) [{ell.n_pad}, {ell.d_pad}] n_colors={ncol} allow+cur")
    # the palette of test_chunked_first_fit_wide_palette, 4500 colours:
    # random ids (the padding id among them) into a random colour vector,
    # rows of whole 16-byte vectors and rows that are not
    n_ids = 1000
    colors = torch.randint(-1, 4500, (n_ids,), generator=gen, device=device, dtype=i32)
    allow = torch.randint(0, 2, (4500,), generator=gen, device=device, dtype=i32)
    allow[:64] = 0
    cur = torch.randint(-1, 4500, (256,), generator=gen, device=device, dtype=i32)
    for d_pad in (40, 37):
        ids = torch.randint(0, n_ids + 1, (256, d_pad), generator=gen, device=device, dtype=i32)
        err = max(err, _k3_check(k3, ids, colors, allow, 4500, cur,
                                 f"4500 colours, random ids [256, {d_pad}], allow+cur"))
    # config 3: one band of the main path's first fit, random colours
    ncol = ell3.max_degree
    colors = _real_colors(ell3.n_nodes, ell3.n_pad, ncol, gen, device)
    neigh = ell3.neighbors[:sb]
    allow = torch.ones((ncol,), dtype=i32, device=device)
    err = max(err, _k3_check(k3, neigh, colors, allow, ncol, None,
                             f"config-3 band [{sb}, {ell3.d_pad}] n_colors={ncol}"))
    k_ms = _median_ms(lambda: k3.first_fit_cuda(neigh, colors, allow, ncol))
    p_ms = _median_ms(lambda: k3.first_fit_plain(neigh, colors, allow, ncol))
    slots = int((neigh < colors.shape[0]).sum())
    n_bytes = _nbytes(neigh, allow) + _gathered_bytes(neigh, colors) + sb * 4
    print(f"phase 7 K3 config-3 band: kernel {k_ms:.3f} ms, plain (gather + first fit) "
          f"{p_ms:.3f} ms (median of {TIMED_RUNS}, CUDA events); {slots} neighbour slots, "
          f"moves {n_bytes} bytes")
    return err, k_ms, p_ms, n_bytes, slots


def _k2_inputs(ell, params, gen, device, taboo_max: int, rows: int | None = None):
    """neighbors, colors, cur, taboo, row0, unif, p_eff for a sweep over
    the first ``rows`` rows of ``ell`` (its real rows by default), random
    colours (phantoms n_colors), handed over as the main path does: the
    real vertices' colour vector (models/mcmc.py:_ell_sweep)."""
    import torch

    from mcmc_colorer_tpu_torch.models.mcmc import _needs_histogram, _variant_distribution
    from mcmc_colorer_tpu_torch.ops.neighbor import color_histogram

    rows = rows or ell.n_nodes
    colors = _real_colors(ell.n_nodes, ell.n_pad, params.n_colors, gen, device)
    taboo = torch.randint(0, taboo_max + 1, (rows,), generator=gen, device=device,
                          dtype=torch.int32)
    unif = torch.rand((rows,), generator=gen, device=device)
    hist = (color_histogram(colors, params.n_colors, ell.node_mask)
            if _needs_histogram(params) else None)
    p_eff = _variant_distribution(params, hist, ell.n_nodes, device)
    return (ell.neighbors[:rows], colors[: ell.n_nodes], colors[:rows].contiguous(), taboo,
            0, unif, p_eff)


def _k2_bytes_ops(args, n_colors: int, self_ids=None) -> tuple[int, int]:
    """What one K2 launch on ``args`` must move (the ids, the colours they
    name, the row vectors, the own ids if given and p_eff read once; star,
    qstar, new_taboo and the conflict count written once) and its
    operations (a compare a slot, a CDF step a colour)."""
    neigh, colors, cur, taboo, _, unif, p_eff = args
    rows, d_pad = neigh.shape
    n_bytes = (_nbytes(neigh, cur, taboo, unif) + _gathered_bytes(neigh, colors)
               + 4 * n_colors + rows * 12 + 8)
    if self_ids is not None:
        n_bytes += _nbytes(self_ids)
    return n_bytes, rows * (d_pad + n_colors)


def _k2_check(k2, args, params, label, l2=False, phase=8, self_ids=None):
    """K2 against its plain version: exact conflicts, samples equal but at
    CDF-boundary rows, new_taboo equal and qstar within rtol 1e-5 where
    the samples agree.  ``l2`` forces the L2 regime; ``self_ids`` gives
    the rows' own ids.  Returns (boundary fraction, max |qstar error|)."""
    colors = args[1]
    got = k2.resample_sweep_cuda(*args, params.epsilon, params, self_ids, _l2=l2)
    want = k2.resample_sweep_plain(*args, params.epsilon, params, self_ids)
    regime = "staged" if k2.sweep_shape(colors.shape[-1], params.n_colors, l2).staged else "L2"
    return _k2_compare(k2, got, want, args, params, f"{label} ({regime})", phase)


def _k2_compare(k2, got, want, args, params, label, phase):
    """K2's outputs ``got`` against its plain version's ``want`` on one
    chain's ``args``: the rule of ``_k2_check``.  Returns (boundary
    fraction, max |qstar error|)."""
    import torch

    from mcmc_colorer_tpu_torch.models.mcmc import _proposal_q
    from mcmc_colorer_tpu_torch.ops.neighbor import occupancy_matrix

    neigh, colors, cur, taboo, row0, unif, p_eff = args
    _require(int(got[3]) == int(want[3]),
             f"K2 conflicts {int(got[3])} vs plain {int(want[3])} at {label}")
    rows = neigh.shape[0]
    mism = (got[0] != want[0]).nonzero()[:, 0]
    frac = mism.numel() / rows
    # one boundary row is allowed on a shape of fewer than 1000 rows (a
    # degree class or a frontier may hold a few dozen)
    _require(mism.numel() <= max(1, BOUNDARY_MAX_FRACTION * rows),
             f"K2 samples differ at {mism.numel()} of {rows} rows at {label}")
    if mism.numel():
        nc = k2.gathered_colors(neigh[mism], colors)
        eps = torch.tensor(params.epsilon, dtype=torch.float32, device=neigh.device)
        q = _proposal_q(cur[mism], occupancy_matrix(nc, params.n_colors), params,
                        p_eff, eps, params.n_colors)
        cdf = torch.cumsum(q, dim=1)
        k = want[0][mism].to(torch.int64)
        u = unif[mism]
        near = (u - cdf.gather(1, k[:, None])[:, 0]).abs() <= BOUNDARY_RTOL * u
        before = cdf.gather(1, (k - 1).clamp(min=0)[:, None])[:, 0]
        near |= (k >= 1) & ((u - before).abs() <= BOUNDARY_RTOL * u)
        _require(bool(near.all()), f"K2 differs off a CDF boundary at {label}")
    keep = got[0] == want[0]
    _require(torch.equal(got[2][keep], want[2][keep]), f"K2 new_taboo differs at {label}")
    qerr = (got[1] - want[1]).abs()[keep]
    rel = (qerr / want[1].abs()[keep].clamp(min=1e-30)).max()
    _require(float(rel) <= 1e-5, f"K2 qstar off by {float(rel):.3g} (relative) at {label}")
    print(f"phase {phase} K2 {label}: conflicts {int(got[3])} exact; {mism.numel()} boundary "
          f"rows of {rows}; qstar max rel err {float(rel):.3g}")
    return frac, float(qerr.max())


def _k2_both(k2, args, params, label, phase=8, self_ids=None):
    """``_k2_check`` in the regime the shape takes and in L2."""
    f1, e1 = _k2_check(k2, args, params, label, phase=phase, self_ids=self_ids)
    f2, e2 = _k2_check(k2, args, params, label, l2=True, phase=phase, self_ids=self_ids)
    return max(f1, f2), max(e1, e2)


def _k2_timed(k2, args, params, label, plain_runs=TIMED_RUNS, phase=8, self_ids=None):
    """K2 (the shape's regime, and forced to L2 where that differs) and its
    plain version, timed; a row of the kernels line's K2 ``shapes``."""
    colors = args[1]
    shape = k2.sweep_shape(colors.shape[0], params.n_colors)
    k_ms = _median_ms(lambda: k2.resample_sweep_cuda(*args, params.epsilon, params, self_ids))
    l2_ms = (_median_ms(lambda: k2.resample_sweep_cuda(*args, params.epsilon, params,
                                                       self_ids, _l2=True))
             if shape.staged else k_ms)
    p_ms = _median_ms(lambda: k2.resample_sweep_plain(*args, params.epsilon, params, self_ids),
                      runs=plain_runs)
    n_bytes, ops = _k2_bytes_ops(args, params.n_colors, self_ids)
    rows, d_pad = args[0].shape
    regime = "staged" if shape.staged else "L2"
    print(f"phase {phase} K2 {label} [{rows}, {d_pad}] n_ids={colors.shape[0]} "
          f"n_colors={params.n_colors}: {regime} ({shape.warps} warps, {shape.copies} mask "
          f"copies, {shape.smem_bytes} bytes of shared memory) {k_ms:.3f} ms, L2 regime "
          f"{l2_ms:.3f} ms, plain {p_ms:.3f} ms (median of {TIMED_RUNS}, plain of "
          f"{plain_runs}, CUDA events); moves {n_bytes} bytes")
    return {"shape": label, "regime": regime, "rows": rows, "d_pad": d_pad, "ms": k_ms,
            "l2_ms": l2_ms, "plain_ms": p_ms, "bytes": n_bytes, "ops": ops}


def phase_k2(device, ell3, sb):
    """K2 against its plain version, in both regimes, at the test shapes
    and at the config-3 band and sweep (L2); timed at the sweep, the
    shape the main path launches it at."""
    import torch

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.graph.generate import erdos_renyi
    from mcmc_colorer_tpu_torch.ops import resample as k2

    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    frac, qerr = 0.0, 0.0
    # tests/test_pallas_resample.py:test_pallas_matches_xla_sweep
    g = erdos_renyi(500, 0.05, seed=3)
    ell = g.to_ell(pad_nodes_to=128, device=device)
    for kind in (ProposalKind.STANDARD, ProposalKind.BALANCE_DYNAMIC,
                 ProposalKind.DECREASE_EXP, ProposalKind.BALANCE_LINE):
        for taboo_iters in (0, 3):
            p = MCMCParams(n_colors=g.max_degree, proposal=kind,
                           taboo_iterations=taboo_iters, epsilon=1e-4)
            f, e = _k2_both(k2, _k2_inputs(ell, p, gen, device, 1), p,
                            f"ER(500, 0.05) {kind.value} taboo {taboo_iters}")
            frac, qerr = max(frac, f), max(qerr, e)
    # test_chunked_kernel_wide_palette_matches_xla: 4500 colours
    g = erdos_renyi(512, 0.05, seed=3, use_native=False)
    ell = g.to_ell(pad_nodes_to=128, device=device)
    for kind in (ProposalKind.STANDARD, ProposalKind.BALANCE_DYNAMIC,
                 ProposalKind.DECREASE_EXP):
        p = MCMCParams(n_colors=4500, proposal=kind, taboo_iterations=2, epsilon=1e-6)
        f, e = _k2_both(k2, _k2_inputs(ell, p, gen, device, 1), p,
                        f"ER(512, 0.05) 4500 colours {kind.value}")
        frac, qerr = max(frac, f), max(qerr, e)
    # config 3, balance-dynamic: one band, then the whole sweep in one
    # launch, as the main path runs it
    p = MCMCParams(n_colors=ell3.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC)
    f, e = _k2_check(k2, _k2_inputs(ell3, p, gen, device, 0, rows=sb), p,
                     f"config-3 band [{sb}, {ell3.d_pad}]")
    frac, qerr = max(frac, f), max(qerr, e)
    args = _k2_inputs(ell3, p, gen, device, 0)
    f, e = _k2_check(k2, args, p, f"config-3 sweep [{ell3.n_nodes}, {ell3.d_pad}]")
    frac, qerr = max(frac, f), max(qerr, e)
    row = _k2_timed(k2, args, p, "config-3 sweep", plain_runs=3)
    return frac, qerr, row


def _chain_peak(colorer, seed: int) -> int:
    """Peak device bytes, above what was allocated before, of the chain
    alone: ``MCMCColorer.run``'s do-while on the same draws, without the
    tailcut that follows it."""
    import torch

    from functools import partial

    from mcmc_colorer_tpu_torch.models import mcmc as tm
    from mcmc_colorer_tpu_torch.utils.rng import ChainSources, TorchUniformSource

    ell, p = colorer.ell, colorer.params
    sources = ChainSources([TorchUniformSource(seed, 0, colorer.device)], colorer.device)
    state = tm._chain_init(ell.n_pad, ell.n_nodes, p, sources, colorer.device,
                           node_mask=ell.node_mask)
    body = partial(tm._chain_body, params=p, block=colorer.block, n_nodes=ell.n_nodes,
                   sources=sources, sweep=tm._sweep_pallas_fused)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tm._chain_segment(ell, state, p.max_iterations, params=p, n_nodes=ell.n_nodes, fused=True,
                      body=body)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase_config3(device, g):
    """The slice-2 main path at BASELINE config 3: MCMCColorer (K2 sweep,
    K3 tailcut) at numColRatio 1, 2, 4, then GreedyFF (K3).  Returns the
    K2 and K3 launches of these runs, GreedyFF's run with its K3
    launches, the MCMC runs by ratio, and by ratio the chain's peak device
    bytes (``_chain_peak``) with the colorer's row block."""
    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.models.base import check_coloring
    from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
    from mcmc_colorer_tpu_torch.ops import firstfit as k3
    from mcmc_colorer_tpu_torch.ops import resample as k2

    import torch

    k2_total = k3_total = 0
    fulls, peaks = {}, {}
    for ratio in CONFIG3_RATIOS:
        n_col = max(4, int(g.max_degree / ratio))
        params = MCMCParams(n_colors=n_col, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
        c = MCMCColorer(g, params, backend="pallas", device=device)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        k2.launches = k3.launches = 0
        r = c.run(seed=CONFIG3_RUN_SEED)
        l2, l3 = k2.launches, k3.launches
        peak = torch.cuda.max_memory_allocated() - base
        chain_peak = _chain_peak(c, CONFIG3_RUN_SEED)
        peaks[ratio] = (chain_peak, c.block)
        k2_total, k3_total = k2_total + l2, k3_total + l3
        x = r.extra
        t0 = time.perf_counter()
        valid = check_coloring(g, r.colors)
        check_s = time.perf_counter() - t0
        print(
            f"phase 9 config3 ratio={ratio} n_colors={n_col}: setup (ELL) "
            f"{c.setup_seconds:.3f} s; iterations {r.iterations}, sweeps {x['sweeps']}, "
            f"chain {x['chain_seconds']:.3f} s "
            f"({x['chain_seconds'] / max(x['sweeps'], 1) * 1e3:.3f} ms/sweep), tailcut "
            f"rounds {x['tailcut_rounds']} {x['tailcut_seconds']:.3f} s, run "
            f"{r.duration_ms / 1e3:.3f} s; used colours {r.used_colors}, balance index "
            f"{r.balance_index(CONFIG3_P):.4f}; K2 launches {l2}, K3 launches {l3}; "
            f"peak device memory of the run {peak} bytes above the {base} allocated before "
            f"it, of the chain alone {chain_peak}; valid {valid} (check {check_s:.3f} s), "
            f"final conflicts {x['final_conflicts']}"
        )
        _require(l2 > 0 and l3 > 0, f"ratio {ratio}: K2 launched {l2}, K3 {l3} times")
        _require(l2 == x["sweeps"], f"ratio {ratio}: {l2} K2 launches in {x['sweeps']} sweeps")
        _require(valid and x["final_conflicts"] == 0, f"ratio {ratio}: invalid colouring")
        fulls[ratio] = r
        del c
    k3.launches = 0
    t0 = time.perf_counter()
    gff = GreedyFFColorer(g, device=device)
    setup_s = time.perf_counter() - t0
    r = gff.run()
    l3 = k3.launches
    k3_total += l3
    valid = check_coloring(g, r.colors)
    print(f"phase 9 config3 GreedyFF: setup {setup_s:.3f} s; {r.n_colors} colours in "
          f"{r.iterations} rounds (palette bound {gff.max_colors}), run "
          f"{r.duration_ms / 1e3:.3f} s; K3 launches {l3}; valid {valid}")
    _require(l3 > 0, "GreedyFF launched K3 no time")
    _require(valid, "GreedyFF: invalid colouring")
    return k2_total, k3_total, (r, l3), fulls, peaks


def _ell_conflicts(ell, colors, rows: int = 1 << 15) -> int:
    """Conflict edges of ``colors`` (host, [n]) over ``ell``'s rows, counted
    on the card a block of rows at a time (each edge seen from both ends)."""
    import torch

    n, n_pad = ell.n_nodes, ell.n_pad
    c = torch.full((n_pad + 1,), -1, dtype=torch.int64, device=ell.neighbors.device)
    c[:n] = torch.as_tensor(colors, device=c.device)
    twice = 0
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        twice += int((c[ell.neighbors[r0:r1].long()] == c[r0:r1, None]).sum())
    return twice // 2


def phase_hash_ell_config3(device, seed=CONFIG3_RUN_SEED):
    """BASELINE config 3 on the route with no host graph: ``HashGraph(10^6,
    0.001, 0)`` on the card, its flat ELL built by K5 (the count and the
    fill, two launches, counted from 0), the rectangle ``MCMCColorer``
    asks for; bands of its rows at the start, the middle, a random place
    and the end (into the phantom rows) held exactly against the plain
    version's same rows computed on the card; K5's count and fill timed
    beside that plain version (its time over the sampled rows, scaled to
    n) and the least time of the work (``colorbench/roofline/k5.py``'s
    booking); then ``MCMCColorer`` over it at numColRatio 1, 2, 4 (K2 a
    sweep, K3 in the tailcut, K5 not again), each colouring checked on the
    card against K5's rows.  Returns (K2 launches, K3 launches, the
    kernels line's K5 entry)."""
    import torch

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind, default_n_colors
    from mcmc_colorer_tpu_torch.graph.container import HashGraph, degree_pad_for
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer, choose_block_size
    from mcmc_colorer_tpu_torch.ops import firstfit as k3
    from mcmc_colorer_tpu_torch.ops import hash_ell as k5
    from mcmc_colorer_tpu_torch.ops import resample as k2

    n, p, gs = CONFIG3_N, CONFIG3_P, HASH3_GRAPH_SEED
    k5.launches = 0
    t0 = time.perf_counter()
    hg = HashGraph(n, p, gs, device=device)
    pad = degree_pad_for(hg, "pallas")
    ell = hg.to_ell(pad_nodes_to=choose_block_size(n, 1), pad_degree_to=pad, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    main_launches = k5.launches
    n_pad, d_pad = ell.n_pad, ell.d_pad
    print(f"phase 41 HashGraph({n}, {p}, {gs}) on the card: m={hg.n_edges} "
          f"max_degree={hg.max_degree}; ELL [{n_pad}, {d_pad}] "
          f"({n_pad * d_pad * 4 / 1e9:.3f} GB) built by K5 in {build_s:.3f} s, "
          f"{main_launches} launches")
    _require(main_launches == 2, f"K5 launched {main_launches} times for one build, not 2")
    _require(d_pad == k5.d_pad_for(hg.max_degree, pad)
             and int(ell.degrees.max()) == hg.max_degree,
             "the rectangle's width is not the max degree's")
    _require(int(ell.degrees.sum()) == 2 * hg.n_edges and not ell.degrees[n:].any(),
             "the degrees do not add up to twice the edges")
    _require(bool((ell.neighbors[n:] == n_pad).all()), "a phantom row holds a neighbour")

    gen = torch.Generator().manual_seed(seed)
    r = int(torch.randint(HASH3_BAND_ROWS, n - 2 * HASH3_BAND_ROWS, (1,), generator=gen))
    half = HASH3_BAND_ROWS // 2
    bands = [(0, HASH3_BAND_ROWS), (n // 2 - half, n // 2 + half), (r, r + HASH3_BAND_ROWS),
             (n - HASH3_BAND_ROWS + 32, n + 32)]
    k5.hash_ell_plain_rows(n, p, gs, n_pad, d_pad, 0, 4, device=device)  # warm-up, untimed
    plain_s, real_rows = 0.0, 0
    for lo, hi in bands:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows, deg = k5.hash_ell_plain_rows(n, p, gs, n_pad, d_pad, lo, hi, device=device)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        real_rows += max(0, min(hi, n) - lo)
        _require(torch.equal(ell.degrees[lo:hi], deg), f"K5's degrees of rows [{lo}, {hi}) differ "
                 f"from the plain version's")
        _require(torch.equal(ell.neighbors[lo:hi], rows), f"K5's rows [{lo}, {hi}) differ from "
                 f"the plain version's")
    plain_ms = plain_s / real_rows * n * 1e3
    print(f"phase 41 K5 rows {bands}: exact against the plain version on the card "
          f"({real_rows} real rows, plain {plain_s:.3f} s: {plain_ms / 1e3:.1f} s scaled to n)")

    count_ms = _median_ms(lambda: k5.hash_ell_degrees(n, p, gs, n_pad, device), runs=3)
    fill_ms = _median_ms(lambda: k5.hash_ell_fill(n, p, gs, ell.degrees, d_pad), runs=3)
    shapes = []
    for label, ms, n_bytes, ops in (("count", count_ms, 4 * n_pad, 0),
                                    ("fill", fill_ms, 4 * n_pad * d_pad, 8 * (n * (n - 1) // 2))):
        b_ms, b_by = _bound(n_bytes, ops, INT32_OPS_PER_S)
        shapes.append({"shape": f"{label} [{n_pad}, {d_pad}]", "launches": 1, "ms": ms,
                       "bytes": n_bytes, "ops": ops, "bound_ms": b_ms, "bound_by": b_by})
    bound_ms = sum(x["bound_ms"] for x in shapes)
    print(f"phase 41 K5 count {count_ms:.3f} ms, fill {fill_ms:.3f} ms (median of 3); the "
          f"build's bound {bound_ms:.3f} ms, {bound_ms / (count_ms + fill_ms):.2%} of it")

    k2_total = k3_total = 0
    timed = k5.launches
    for ratio in CONFIG3_RATIOS:
        n_col = default_n_colors(hg.max_degree, ratio)
        params = MCMCParams(n_colors=n_col, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
        c = MCMCColorer(hg, params, backend="pallas", device=device)
        _require(c.ell is ell, f"ratio {ratio}: the colourer built its own rectangle")
        k2.launches = k3.launches = 0
        res = c.run(seed=seed)
        l2, l3 = k2.launches, k3.launches
        k2_total, k3_total = k2_total + l2, k3_total + l3
        x = res.extra
        conflicts = _ell_conflicts(ell, res.colors)
        off = int(((res.colors < 0) | (res.colors >= n_col)).sum())
        print(f"phase 41 hash config3 ratio={ratio} n_colors={n_col}: setup "
              f"{c.setup_seconds:.3f} s; sweeps {x['sweeps']}, chain {x['chain_seconds']:.3f} s "
              f"({x['chain_seconds'] / max(x['sweeps'], 1) * 1e3:.3f} ms/sweep), tailcut rounds "
              f"{x['tailcut_rounds']} {x['tailcut_seconds']:.3f} s, run {res.duration_ms / 1e3:.3f} "
              f"s; balance index {res.balance_index(p):.4f}; K2 launches {l2}, K3 launches {l3}; "
              f"conflict edges on the card {conflicts}, off the palette {off}")
        _require(l2 > 0 and l2 == x["sweeps"], f"ratio {ratio}: {l2} K2 launches in "
                 f"{x['sweeps']} sweeps")
        _require(conflicts == 0 and off == 0 and x["final_conflicts"] == 0,
                 f"ratio {ratio}: invalid colouring")
        del c
    _require(k5.launches == timed, "K5 ran again in the colourers' set-up")
    _require(k3_total > 0, "the tailcuts launched K3 no time")
    entry = {
        "name": "hash_ell",
        "route": "cuda",
        "source": "mcmc_colorer_tpu_torch/csrc/hash_ell.cu",
        "replaces": None,  # the JAX package builds no ELL of a graph it has not sampled
        "launches": main_launches,
        "max_abs_err": 0,
        "rows_checked": real_rows,
        "ms": count_ms + fill_ms,  # the build: one count and one fill launch
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if all(x["bound_by"] == "bytes" for x in shapes) else "operations",
        "bound_share": bound_ms / (count_ms + fill_ms),
        "library_ms": None,
        "shapes": shapes,
    }
    return k2_total, k3_total, entry


def phase_config4(device):
    """BASELINE config 4: a BA graph written in the network-repository
    layout (two self-arcs), converted, stripped, loaded by the native
    importer, then coloured by MCMCColorer and by GreedyFF with K3 and
    with its plain version.  Returns (graph, the MCMC run, GreedyFF's run
    with K3), for phase 20."""
    import numpy as np

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.graph import io as gio
    from mcmc_colorer_tpu_torch.graph.generate import barabasi_albert
    from mcmc_colorer_tpu_torch.models.base import check_coloring
    from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer

    t0 = time.perf_counter()
    g0 = barabasi_albert(CONFIG4_N, CONFIG4_M, seed=CONFIG4_SEED)
    with tempfile.TemporaryDirectory() as td:
        raw = os.path.join(td, "soc-sample.mtx")
        u = np.repeat(np.arange(g0.n, dtype=np.int64), g0.degrees)
        v = g0.cols.astype(np.int64)
        mask = u < v
        with open(raw, "w") as f:
            f.write("%% networkrepository sample (BA 50k regime)\n")
            f.write(f"{g0.n} {g0.n} {g0.n_edges}\n")
            f.writelines(f"{a} {b}\n" for a, b in zip(u[mask], v[mask]))
            f.write("7 7\n17 17\n")  # self-arcs, as real dumps have
        conv = os.path.join(td, "soc-sample.txt")
        gio.convert_network_repository(raw, conv)
        clean = os.path.join(td, "soc-sample-clean.txt")
        n_self = gio.strip_self_arcs(conv, clean)
        g = gio.load_edge_list(clean)
    io_s = time.perf_counter() - t0
    _require(n_self == 2, f"{n_self} self-arcs stripped, expected 2")
    _require((g.n, g.n_edges, g.max_degree) == (g0.n, g0.n_edges, g0.max_degree),
             "the loaded graph differs from the written one")
    params = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC,
                        tailcut=True)
    r = MCMCColorer(g, params, backend="pallas", device=device).run(seed=CONFIG4_RUN_SEED)
    valid = check_coloring(g, r.colors)
    a = GreedyFFColorer(g, backend="pallas", device=device).run()
    b = GreedyFFColorer(g, backend="xla", device=device).run()
    same = bool(np.array_equal(a.colors, b.colors))
    print(f"phase 10 config4 BA({CONFIG4_N}, {CONFIG4_M}) -> network-repository layout -> "
          f"convert, strip {n_self} self-arcs -> native import: n={g.n} m={g.n_edges} "
          f"max_degree={g.max_degree} ({io_s:.3f} s); MCMC iterations {r.iterations}, "
          f"tailcut rounds {r.extra['tailcut_rounds']}, used colours {r.used_colors}, "
          f"run {r.duration_ms / 1e3:.3f} s, valid {valid}; GreedyFF {a.n_colors} colours "
          f"in {a.iterations} rounds, K3 and plain colours identical {same}")
    _require(valid and r.extra["final_conflicts"] == 0, "config 4: invalid MCMC colouring")
    _require(same and check_coloring(g, a.colors), "config 4: GreedyFF K3 vs plain differ")
    return g, r, a


def phase_k2_vs_k1(device, c, g, seed=5):
    """The K2 chain and the K1 chain on one graph (phase 4's ER(100k,
    0.01), its params and seed), both warm; K2 there in the staged regime,
    held against its plain version in both regimes on the chain's ELL and
    timed.  Returns (K2 launches of the timed chain run, its
    ``_k2_timed`` row, boundary fraction, max |qstar error|, the K1 and
    the K2 chain's runs)."""
    import torch

    from mcmc_colorer_tpu_torch.config import MCMCParams
    from mcmc_colorer_tpu_torch.models.base import check_coloring
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
    from mcmc_colorer_tpu_torch.ops import resample as k2

    def per_sweep(r):
        return r.extra["chain_seconds"] / max(r.extra["sweeps"], 1) * 1e3

    r1 = c.run(seed=seed)
    colorer = MCMCColorer(g, c.params, backend="pallas", device=device)
    colorer.run(seed=seed)  # warm-up
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k2.launches = 0
    r2 = colorer.run(seed=seed)
    launches = k2.launches
    peak = torch.cuda.max_memory_allocated() - base
    chain_peak = _chain_peak(colorer, seed)
    ell = colorer.ell
    print(
        f"phase 11 K2 vs K1, ER({BENCH_N}, {BENCH_P}) n_colors={c.params.n_colors} seed "
        f"{seed}, warm: resident/K1 {per_sweep(r1):.3f} ms/sweep, {r1.iterations} "
        f"iterations, {r1.extra['sweeps']} sweeps, run {r1.duration_ms / 1e3:.3f} s; "
        f"ELL/K2 [{ell.n_pad}, {ell.d_pad}] {per_sweep(r2):.3f} ms/sweep, {r2.iterations} "
        f"iterations, {r2.extra['sweeps']} sweeps, tailcut rounds "
        f"{r2.extra['tailcut_rounds']}, run {r2.duration_ms / 1e3:.3f} s (ELL setup "
        f"{colorer.setup_seconds:.3f} s); K2 launches {launches}; peak device memory of the "
        f"run {peak} bytes above the {base} allocated before it, of the chain alone "
        f"{chain_peak}"
    )
    _require(check_coloring(g, r2.colors) and r2.extra["final_conflicts"] == 0,
             "phase 11: invalid K2 colouring")
    _require(launches == r2.extra["sweeps"] > 0,
             f"phase 11: {launches} K2 launches in {r2.extra['sweeps']} sweeps")
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    p = MCMCParams(n_colors=c.params.n_colors, proposal=c.params.proposal)
    args = _k2_inputs(ell, p, gen, device, 0)
    _require(k2.sweep_shape(args[1].shape[0], p.n_colors).staged,
             "phase 11: K2 does not stage the colour vector")
    frac, qerr = _k2_both(k2, args, p, f"ER({BENCH_N}, {BENCH_P}) sweep", phase=11)
    row = _k2_timed(k2, args, p, f"ER({BENCH_N}, {BENCH_P}) sweep", phase=11)
    return launches, row, frac, qerr, r1, r2


def _vff_k3_checks(k3, c, gff):
    """K3 against its plain version at VFF's two call sites with the real
    ``allow`` and ``cur`` of phase 2's first round on ``c``'s graph, from
    GreedyFF's colours ``gff``: the first row band of the full pass
    (vff.py:_tentative_rebalance) and the frontier round at its cap
    (vff.py:_vff_active_round).  The frontier round is also timed.
    Returns the largest error."""
    import torch

    from mcmc_colorer_tpu_torch.models.mcmc import _bands
    from mcmc_colorer_tpu_torch.models.mcmc_active import _buckets, pick_cap
    from mcmc_colorer_tpu_torch.models.vff import _phase2_start
    from mcmc_colorer_tpu_torch.ops.neighbor import frontier_ids, take_rows

    ell, max_colors, dev = c.ell, c.max_colors, c.device
    colors = torch.zeros((ell.n_pad,), dtype=torch.int32, device=dev)
    colors[: ell.n_nodes] = torch.from_numpy(gff.colors).to(dev)
    n_used, gamma, bins, unb, _ = _phase2_start(ell, colors, max_colors)
    allow = ((bins < gamma) & (torch.arange(max_colors, device=dev) < n_used)).to(torch.int32)
    s, e = next(_bands(ell.n_pad, ell.d_pad))
    err = _k3_check(k3, ell.neighbors[s:e], colors, allow, max_colors, colors[s:e],
                    f"VFF full pass, band [{e - s}, {ell.d_pad}] n_colors={max_colors}, "
                    f"{int(allow.sum())} classes allowed", phase=13)
    n_unb = int(unb.sum())
    cap = pick_cap(_buckets(ell.n_pad, c._min_bucket, c._bucket_factor), n_unb)
    ids, valid = frontier_ids(unb, cap)
    rows = take_rows(ell, ids, valid)
    cur = torch.where(valid, colors[ids.clamp(max=ell.n_pad - 1).to(torch.int64)], max_colors)
    label = f"VFF frontier round, rows [{cap}, {ell.d_pad}] ({n_unb} flagged)"
    err = max(err, _k3_check(k3, rows, colors, allow, max_colors, cur, label, phase=13))
    k_ms = _median_ms(lambda: k3.first_fit_cuda(rows, colors, allow, max_colors, cur))
    p_ms = _median_ms(lambda: k3.first_fit_plain(rows, colors, allow, max_colors, cur), runs=3)
    print(f"phase 13 K3 {label}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms (CUDA events)")
    return err


def phase_frontier_config3(device, g, full_gff):
    """Slice 4 at BASELINE config 3: the frontier GreedyFF (K3 on the
    frontier's rows, palette cut to d_pad + 1) against phase 9's full
    loop, then VFF full and frontier (K3 with allow and cur), each also
    with K3's plain version: all four must end phase 2 in the same
    colours, rounds and livelock flag.  Returns (K3 launches of the K3
    runs, largest K3 error at VFF's call sites)."""
    import numpy as np

    from mcmc_colorer_tpu_torch.models.base import check_coloring
    from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer
    from mcmc_colorer_tpu_torch.models.vff import VFFColorer
    from mcmc_colorer_tpu_torch.ops import firstfit as k3

    full, full_l3 = full_gff
    t0 = time.perf_counter()
    k3.launches = 0
    r = GreedyFFColorer(g, active=True, device=device).run()
    l3 = total = k3.launches
    same = bool(np.array_equal(r.colors, full.colors))
    print(f"phase 12 config3 frontier GreedyFF: {r.n_colors} colours in {r.iterations} "
          f"rounds, run {r.duration_ms / 1e3:.3f} s (full loop {full.duration_ms / 1e3:.3f} "
          f"s); K3 launches {l3} (full loop {full_l3}); colours equal the full loop's "
          f"{same}; phase {time.perf_counter() - t0:.3f} s")
    _require(l3 > 0, "the frontier GreedyFF launched K3 no time")
    _require(same and r.iterations == full.iterations,
             "the frontier GreedyFF differs from the full loop")
    runs, err = {}, 0
    for active in (False, True):
        for backend in ("pallas", "xla"):
            t0 = time.perf_counter()
            c = VFFColorer(g, active=active, backend=backend, device=device)
            k3.launches = 0
            r = c.run()
            l3 = k3.launches
            t_run = time.perf_counter() - t0
            runs[active, backend] = (r, c.phase2_colors)
            name = f"{'frontier' if active else 'full'}, {'K3' if backend == 'pallas' else 'plain'}"
            if backend == "xla":
                _require(l3 == 0, "VFF's plain route launched K3")
                print(f"phase 13 config3 VFF {name}: {r.iterations} phase-2 rounds, livelock "
                      f"{r.extra['livelock_fallback']}, run {r.duration_ms / 1e3:.3f} s")
                continue
            total += l3
            valid = check_coloring(g, r.colors)
            print(f"phase 13 config3 VFF {name}: {r.n_colors} colours used, {r.iterations} "
                  f"phase-2 rounds, livelock {r.extra['livelock_fallback']}, balance index "
                  f"{r.balance_index(CONFIG3_P):.4f} (GreedyFF "
                  f"{full.balance_index(CONFIG3_P):.4f}), run {r.duration_ms / 1e3:.3f} s; "
                  f"K3 launches {l3}; valid {valid}; phase {time.perf_counter() - t0:.3f} s "
                  f"({t_run:.3f} s before the check)")
            _require(l3 > 0, "VFF launched K3 no time")
            _require(valid and int(r.colors.max()) < r.n_colors, "VFF: invalid colouring")
            if not active:
                err = _vff_k3_checks(k3, c, full)
            del c
    # under the livelock fallback the result is GreedyFF's colouring, so
    # the colours phase 2 ended in are compared as well
    r0, p0 = runs[False, "pallas"]
    moved = int((p0 != full.colors).sum())
    for (active, backend), (r, p2) in runs.items():
        _require(np.array_equal(r.colors, r0.colors) and np.array_equal(p2, p0)
                 and (r.n_colors, r.iterations, r.extra) == (r0.n_colors, r0.iterations, r0.extra),
                 f"VFF active={active} backend={backend} differs from the full loop with K3")
    _require(moved > 0, "VFF's phase 2 moved no vertex")
    print(f"phase 13 config3 VFF: full and frontier, K3 and plain: equal colours, rounds, "
          f"livelock flag and phase-2 colours ({moved} vertices moved off GreedyFF's colours)")
    return total, err


def _k1_luby_shapes(k1, c, seed):
    """K1 against its plain version, exactly, at resident Luby's two
    shapes on its own adjacency (``c.adj``), with colours of the kinds
    its rounds pass: the degree classes of a random half of the vertices
    (the survival test), and one colour for a sparse set (the survivors'
    neighbours).  Timed.  Returns one (n_col_pad, max_abs_err, kernel_ms,
    plain_ms, bytes moved, adds) a shape."""
    import torch

    from mcmc_colorer_tpu_torch.ops.dense_adj import n_col_pad_of
    from mcmc_colorer_tpu_torch.ops.hashgen import degrees_from_packed

    gen = torch.Generator(device=c.adj.device)
    gen.manual_seed(seed)
    u = torch.rand((c.n_pad,), generator=gen, device=c.adj.device)
    sel = c.node_mask & (u < 0.5)
    degrees = degrees_from_packed(c.adj)
    out = []
    for label, colors, n_col in (
        ("degree classes", torch.where(sel, c.rank_class, -1), c.n_classes),
        ("survivors", torch.where(sel & (u < 0.01), 0, -1).to(torch.int32), 1),
    ):
        ncp = n_col_pad_of(n_col)
        e = int((k1.packed_nc_cuda(c.adj, colors, ncp)
                 - k1.packed_nc_reference(c.adj, colors, ncp)).abs().max())
        _require(e == 0, f"K1 differs from its plain version at Luby's {label}: {e}")
        k_ms = _median_ms(lambda: k1.packed_nc_cuda(c.adj, colors, ncp))
        p_ms = _median_ms(lambda: k1.packed_nc_reference(c.adj, colors, ncp), runs=3)
        n_bytes = _nbytes(c.adj, colors) + c.n_pad * ncp * 4
        adds = int(degrees[colors >= 0].sum())  # an add a set bit of a coloured column
        print(f"phase 14 K1 Luby {label} n_pad={c.n_pad} n_col_pad={ncp}: exact; kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms (CUDA events); moves {n_bytes} bytes, "
              f"{adds} adds")
        out.append((ncp, e, k_ms, p_ms, n_bytes, adds))
    return out


def phase_luby(device, g, seed=5):
    """Slice 4's Luby at ER(100k, 0.01) (phase 4's hash graph): the gather
    loop and the frontier loop on the host graph's ELL, and resident Luby
    on the hash graph (K1).  Resident Luby must equal the gather loop on
    the same graph padded to the same n_pad with the same draws.  Returns
    (K1 launches of the resident run, its rounds, K1 at its two shapes:
    ``_k1_luby_shapes``)."""
    import numpy as np

    from mcmc_colorer_tpu_torch.models import luby as tl
    from mcmc_colorer_tpu_torch.models.base import check_coloring
    from mcmc_colorer_tpu_torch.ops import packed_nc as k1
    from mcmc_colorer_tpu_torch.utils.rng import TorchUniformSource

    for active in (False, True):
        t0 = time.perf_counter()
        r = tl.LubyColorer(g, active=active, device=device).run(seed=seed)
        valid = check_coloring(g, r.colors)
        print(f"phase 14 Luby {'frontier' if active else 'gather'} ER({BENCH_N}, {BENCH_P}): "
              f"{r.n_colors} colours in {r.extra['rounds']} rounds, run "
              f"{r.duration_ms / 1e3:.3f} s; valid {valid}; phase "
              f"{time.perf_counter() - t0:.3f} s")
        _require(valid and int(r.colors.min()) >= 0, "Luby: invalid colouring")
    t0 = time.perf_counter()
    k1.launches = 0
    c = tl.LubyColorer(None, resident_spec=(BENCH_N, BENCH_P, 0), device=device)
    setup_s = time.perf_counter() - t0
    r = c.run(seed=seed)
    launches = k1.launches
    rounds = r.extra["rounds"]
    valid = check_coloring(g, r.colors)
    ell = g.to_ell(pad_nodes_to=2048, device=device)
    _require(ell.n_pad == c.n_pad, f"n_pad {ell.n_pad} vs {c.n_pad}")
    colors, _, _ = tl._run_luby(ell, TorchUniformSource(seed, 0, device))
    same = bool(np.array_equal(colors[:BENCH_N].cpu().numpy(), r.colors))
    print(f"phase 14 Luby resident ER({BENCH_N}, {BENCH_P}): {c.n_classes} degree classes, "
          f"setup (hash graph) {setup_s:.3f} s; {r.n_colors} colours in {rounds} "
          f"rounds, run {r.duration_ms / 1e3:.3f} s; K1 launches {launches}; valid {valid}; "
          f"equals the gather loop on the same draws {same}; phase "
          f"{time.perf_counter() - t0:.3f} s")
    _require(launches > 0, "resident Luby launched K1 no time")
    # one launch a shape a round: the survival test, then the neighbours
    _require(launches == 2 * rounds, f"{launches} K1 launches in {rounds} rounds")
    _require(valid and same, "resident Luby: invalid or differs from the gather loop")
    del ell, colors
    return launches, rounds, _k1_luby_shapes(k1, c, seed)


def _frontier_k2_args(graph, params, cap, gen, device):
    """K2's inputs at a frontier of ``cap`` rows of ``graph`` (an ELL or
    ``PackedRows``): three quarters of the cap real vertices drawn at
    random, the padding id after them, their rows taken as the frontier
    iteration takes them (``_rows_of``), random colours, taboo 0.
    Returns (args, self_ids)."""
    import torch

    from mcmc_colorer_tpu_torch.models.mcmc import _needs_histogram, _variant_distribution
    from mcmc_colorer_tpu_torch.models.mcmc_active import _rows_of
    from mcmc_colorer_tpu_torch.ops.neighbor import color_histogram

    n, n_pad = graph.n_nodes, graph.n_pad
    colors = _real_colors(n, n_pad, params.n_colors, gen, device)
    n_valid = min(n, cap * 3 // 4)
    ids = torch.full((cap,), n_pad, dtype=torch.int32, device=device)
    ids[:n_valid] = torch.randperm(n, generator=gen, device=device)[:n_valid].sort().values
    valid = ids < n_pad
    rows = _rows_of(graph, ids, valid)
    cur = torch.where(valid, colors[ids.clamp(max=n_pad - 1).to(torch.int64)], params.n_colors)
    unif = torch.rand((cap,), generator=gen, device=device)
    hist = (color_histogram(colors, params.n_colors, graph.node_mask)
            if _needs_histogram(params) else None)
    p_eff = _variant_distribution(params, hist, n, device)
    taboo = torch.zeros((cap,), dtype=torch.int32, device=device)
    return (rows, colors[:n], cur, taboo, 0, unif, p_eff), ids


def _frontier_k2(k2, graph, params, by_cap, seed, label, phase):
    """K2 with ``self_ids`` against its plain version in the regime of the
    shape and forced to L2, then timed, at each cap a run's frontier took
    (``by_cap``: cap -> iterations), with the run's own graph and
    parameters.  Returns (K2 ``shapes`` rows, each with its launches,
    boundary fraction, max |qstar error|)."""
    import torch

    rows, frac, qerr = [], 0.0, 0.0
    for cap, n in sorted(by_cap.items()):
        gen = torch.Generator(device=graph.node_mask.device)
        gen.manual_seed(seed + cap)
        args, ids = _frontier_k2_args(graph, params, cap, gen, graph.node_mask.device)
        lab = f"{label} frontier cap {cap}"
        f, e = _k2_both(k2, args, params, lab, phase=phase, self_ids=ids)
        row = _k2_timed(k2, args, params, lab, plain_runs=3, phase=phase, self_ids=ids)
        rows.append({**row, "launches": n})
        frac, qerr = max(frac, f), max(qerr, e)
    return rows, frac, qerr


def _host_syncs(fn):
    """Run ``fn`` under torch's CUDA sync debug mode: (its result, for each
    operation that waited for the device, the innermost file:line of the
    package on the stack and the line that warned)."""
    import traceback
    import warnings

    import torch

    pkg = str(ROOT / "mcmc_colorer_tpu_torch")
    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        ours = [f for f in stack if f.filename.startswith(pkg)]
        if not ours:  # the innermost frame outside torch and warnings
            ours = [f for f in stack if "torch" not in f.filename
                    and "warnings" not in f.filename]
        where = f"{Path(ours[-1].filename).name}:{ours[-1].lineno}" if ours else "?"
        sites.append(f"{where} ({Path(filename).name}:{lineno})")

    with warnings.catch_warnings():
        # the mode's first use in a process warns once that it is a
        # prototype, a message that names no sync: let it pass unrecorded
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


def _frontier_syncs(graph, colors, taboo, cnt, params, cap, label, phase, iters=3):
    """Frontier iterations, and a tailcut round, from a chain's end state
    under the sync debug mode, after one iteration that warms up: an
    iteration must read the host once (its statistics), a tailcut round
    never (its loop reads once a round)."""
    import torch

    from mcmc_colorer_tpu_torch.models.mcmc_active import _active_iteration, _tailcut_round
    from mcmc_colorer_tpu_torch.ops.neighbor import color_histogram
    from mcmc_colorer_tpu_torch.utils.rng import TorchUniformSource

    src = TorchUniformSource(phase, 0, colors.device)
    it_sites = []
    for _ in range(iters + 1):
        (colors, taboo, cnt, _), sites = _host_syncs(
            lambda: _active_iteration(graph, colors, taboo, cnt, src, cap=cap, params=params,
                                      backend="pallas"))
        it_sites.append(sites)
    ordered = torch.argsort(color_histogram(colors, params.n_colors, graph.node_mask),
                            stable=True).to(torch.int32)
    _, tc_sites = _host_syncs(lambda: _tailcut_round(graph, colors, cnt, ordered, src, cap=cap,
                                                     params=params))
    warm, it_sites = it_sites[0], it_sites[1:]
    print(f"phase {phase} {label} host reads at cap {cap}: warm-up iteration {warm}; "
          f"frontier iterations {[len(x) for x in it_sites]} "
          f"({sorted({y for x in it_sites for y in x})}), a tailcut round {len(tc_sites)} "
          f"{tc_sites}")
    _require(all(len(x) == 1 for x in it_sites) and not tc_sites,
             f"{label}: a frontier iteration must read the host once and a tailcut round "
             f"never: {it_sites}, {tc_sites}")


def phase_frontier_mcmc_config3(device, g, fulls):
    """Slice 6 at BASELINE config 3: the frontier MCMC chain
    (``ActiveMCMCColorer``, chain seed 31) on phase 9's graph at
    ``CONFIG3_FRONTIER_RATIOS`` (the second runs long enough to leave
    conflicts for the frontier), beside phase 9's full chains ``fulls`` (by ratio).  K2
    launches once a full sweep and once a frontier iteration; the kept
    cnt at the end of each chain equals a fresh banded count; each run's
    frontier K2 is held and timed at each (ratio, cap) the run took, and
    a frontier iteration reads the host once.  Returns (K2 launches at the
    sweep shape, the frontier's K2 rows, boundary fraction, max |qstar
    error|)."""
    import torch

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.models.base import check_coloring
    from mcmc_colorer_tpu_torch.models.mcmc_active import ActiveMCMCColorer, _cnt_of
    from mcmc_colorer_tpu_torch.ops import resample as k2
    from mcmc_colorer_tpu_torch.utils.rng import TorchUniformSource

    full_sweeps = frontier = 0
    k2_rows, frac, qerr = [], 0.0, 0.0
    for ratio in CONFIG3_FRONTIER_RATIOS:
        params = MCMCParams(n_colors=max(4, int(g.max_degree / ratio)),
                            proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
        c = ActiveMCMCColorer(g, params, device=device)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        k2.launches = 0
        r = c.run(seed=31)
        l2 = k2.launches
        peak = torch.cuda.max_memory_allocated() - base
        x = r.extra
        n_front = sum(x["frontier_iterations"].values())
        t0 = time.perf_counter()
        valid = check_coloring(g, r.colors)
        check_s = time.perf_counter() - t0
        full = fulls[ratio]
        fx = full.extra
        print(
            f"phase 16 config3 frontier MCMC ratio={ratio} n_colors={params.n_colors}: setup "
            f"(ELL) {c.setup_seconds:.3f} s; {x['full_sweeps']} full sweeps, switch after "
            f"iteration {x['switch_iteration']}, frontier iterations by cap "
            f"{x['frontier_iterations']}, iterations {r.iterations}, tailcut rounds "
            f"{x['tailcut_rounds']}; chain {x['chain_seconds']:.3f} s, tailcut "
            f"{x['tailcut_seconds']:.3f} s, run {r.duration_ms / 1e3:.3f} s (phase 9's full "
            f"chain: {fx['sweeps']} sweeps, chain {fx['chain_seconds']:.3f} s, run "
            f"{full.duration_ms / 1e3:.3f} s); used colours {r.used_colors}, balance index "
            f"{r.balance_index(CONFIG3_P):.4f}; K2 launches {l2}; peak device memory of the "
            f"run {peak} bytes above the {base} allocated before it; valid {valid} (check "
            f"{check_s:.3f} s), final conflicts {x['final_conflicts']}"
        )
        _require(l2 == x["full_sweeps"] + n_front,
                 f"config 3 frontier: {l2} K2 launches for {x['full_sweeps']} full sweeps and "
                 f"{n_front} frontier iterations")
        _require(valid and x["final_conflicts"] == 0, "config 3 frontier: invalid colouring")
        ch = c._chain(TorchUniformSource(31, 0, device))
        fresh = _cnt_of(c.ell, ch.colors)
        _require(ch.cnt is None or torch.equal(ch.cnt, fresh),
                 "config 3 frontier: the kept cnt is not a re-count")
        print(f"phase 16 cnt invariant ratio={ratio}: "
              + ("no cnt kept (the chain ended in full mode)" if ch.cnt is None else
                 f"the kept cnt at the chain's end ({ch.conflicts} conflict edges, "
                 f"{int((fresh > 0).sum())} conflicting vertices) equals a fresh banded count"))
        full_sweeps, frontier = full_sweeps + x["full_sweeps"], frontier + n_front
        if n_front:
            _frontier_syncs(c.ell, ch.colors, ch.taboo, ch.cnt, params,
                            max(x["frontier_iterations"]), f"config-3 ratio {ratio}", 16)
        rows, f, e = _frontier_k2(k2, c.ell, params, x["frontier_iterations"], 16,
                                  f"config-3 ratio {ratio}", 16)
        k2_rows, frac, qerr = k2_rows + rows, max(frac, f), max(qerr, e)
        del c, ch, fresh
    _require(frontier > 0, "config 3: the frontier chains ran no frontier iteration")
    return full_sweeps, k2_rows, frac, qerr


def phase_resident_frontier(device, g, r_main, r_warm):
    """Slice 6's resident frontier at ER(100k, 0.01), graph seed 0, chain
    seed 5, nCol = max degree, tailcut: the README's command, and the
    same at ε = 1e-5 (``RESIDENT_FRONTIER_EPS``), where the frontier has
    work; K1 for the full sweeps, the cnt at the switch and the NC
    tailcut (the resident chain's shape: exactly one launch each), K2
    with ``self_ids`` on rows unpacked from A, held and timed at each
    (ε, cap) a run took.  Also ``packed_rows_to_ids`` against the host
    ELL's sorted rows, exactly, and one host read a frontier iteration.
    Returns a dict of launches and K2 rows."""
    import torch

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.models.base import check_coloring
    from mcmc_colorer_tpu_torch.models.mcmc_active import PackedRows, _cnt_of_packed
    from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer
    from mcmc_colorer_tpu_torch.ops import packed_nc as k1
    from mcmc_colorer_tpu_torch.ops import resample as k2
    from mcmc_colorer_tpu_torch.ops.dense_adj import packed_rows_to_ids

    out = {"k2": 0, "k1": 0, "k2_rows": [], "frac": 0.0, "qerr": 0.0}
    for eps in RESIDENT_FRONTIER_EPS:
        params = MCMCParams(n_colors=0, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True,
                            epsilon=eps)
        c = ResidentMCMCColorer(BENCH_N, BENCH_P, graph_seed=0, params=params, active=True,
                                device=device)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        k1.launches = k2.launches = 0
        r = c.run(seed=5)
        l1, l2 = k1.launches, k2.launches
        peak = torch.cuda.max_memory_allocated() - base
        x = r.extra
        n_front = sum(x["frontier_iterations"].values())
        tc = x["tailcut_rounds"]
        # a full sweep's NC, the cnt, a tailcut round's exit NC, the first's entry
        want_k1 = x["sweeps"] + 1 + tc + (1 if tc else 0)
        valid = check_coloring(g, r.colors)
        print(
            f"phase 17 resident frontier ER({BENCH_N}, {BENCH_P}) eps={eps:g} "
            f"n_colors={c.params.n_colors}: gen (or the cached hash graph) "
            f"{c.gen_seconds:.3f} s; {x['sweeps']} full sweeps, switch after iteration "
            f"{x['switch_iteration']}, frontier iterations by cap {x['frontier_iterations']}, "
            f"iterations {r.iterations}, tailcut rounds {tc}; chain {x['chain_seconds']:.3f} s, "
            f"run {r.duration_ms / 1e3:.3f} s (phase 4's full resident chain, cold: "
            f"{r_main.extra['sweeps']} sweeps, chain {r_main.extra['chain_seconds']:.3f} s, "
            f"run {r_main.duration_ms / 1e3:.3f} s; phase 11's, warm: chain "
            f"{r_warm.extra['chain_seconds']:.3f} s, run {r_warm.duration_ms / 1e3:.3f} s); "
            f"K1 launches {l1}, K2 launches {l2}; peak device "
            f"memory of the run {peak} bytes above the {base} allocated before it; valid "
            f"{valid}, final conflicts {x['final_conflicts']}"
        )
        _require(l2 == n_front, f"resident frontier: {l2} K2 launches in {n_front} iterations")
        _require(l1 == want_k1, f"resident frontier: {l1} K1 launches, not {want_k1}")
        _require(valid and x["final_conflicts"] == 0, "resident frontier: invalid colouring")
        out["k2"] += l2
        out["k1"] += l1
        graph = PackedRows(c.adj, c.d_row, c.n, c.node_mask)
        if n_front:  # from random colours: a frontier that fills the cap
            gen = torch.Generator(device=device)
            gen.manual_seed(17)
            colors = _real_colors(c.n, c.n_pad, c.params.n_colors, gen, device)
            cnt = _cnt_of_packed(c.adj, colors, params=c.params, node_mask=c.node_mask)
            _frontier_syncs(graph, colors, torch.zeros_like(cnt), cnt, c.params,
                            max(x["frontier_iterations"]), f"resident eps={eps:g}", 17)
        rows, f, e = _frontier_k2(k2, graph, c.params, x["frontier_iterations"], 17,
                                  f"resident ER({BENCH_N}, {BENCH_P}) eps={eps:g}", 17)
        _require(all(row["regime"] == "staged" for row in rows),
                 "the resident frontier's K2 does not stage")
        out["k2_rows"] += rows
        out["frac"], out["qerr"] = max(out["frac"], f), max(out["qerr"], e)
    _require(out["k2"] > 0, "the resident frontier ran no frontier iteration")
    c1 = c
    # the frontier's rows unpacked from A against the host ELL's, sorted
    ell = g.to_ell(pad_nodes_to=2048, device=device)
    _require(ell.n_pad == c1.n_pad and ell.d_pad >= c1.d_row, "host ELL shape")
    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    ids = torch.randperm(BENCH_N - 1, generator=gen, device=device)[:299].to(torch.int32)
    ids = torch.cat([ids, ids.new_tensor([BENCH_N - 1])]).sort().values
    rows = packed_rows_to_ids(c1.adj.index_select(0, ids), c1.d_row, c1.n_pad)
    host = ell.neighbors.index_select(0, ids).sort(dim=1).values[:, : c1.d_row]
    _require(torch.equal(rows, host), "packed_rows_to_ids differs from the host ELL's rows")
    print(f"phase 17 packed_rows_to_ids: {ids.numel()} rows (the last real vertex among "
          f"them) equal the host ELL's sorted rows, d_row {c1.d_row}")
    del ell, rows, host, c, c1
    return out


def _k1_timed(k1, adj, n, n_colors, gen, label, phase):
    """K1 on ``adj`` with random colours of the ``n`` real vertices against
    its plain version, exactly, then timed.  Returns (n_col_pad,
    max_abs_err, kernel_ms, plain_ms, bytes moved, adds)."""
    from mcmc_colorer_tpu_torch.ops.dense_adj import n_col_pad_of
    from mcmc_colorer_tpu_torch.ops.hashgen import degrees_from_packed

    ncp = n_col_pad_of(n_colors)
    colors = _random_colors(n, adj.shape[0], n_colors, gen, adj.device)
    e = int((k1.packed_nc_cuda(adj, colors, ncp)
             - k1.packed_nc_reference(adj, colors, ncp)).abs().max())
    _require(e == 0, f"K1 differs from its plain version at {label}: {e}")
    k_ms = _median_ms(lambda: k1.packed_nc_cuda(adj, colors, ncp))
    p_ms = _median_ms(lambda: k1.packed_nc_reference(adj, colors, ncp), runs=3)
    n_bytes = _nbytes(adj, colors) + adj.shape[0] * ncp * 4
    adds = int(degrees_from_packed(adj)[colors >= 0].sum())  # an add a set bit of a coloured column
    print(f"phase {phase} K1 {label} n_pad={adj.shape[0]} words={adj.shape[1]} "
          f"n_col_pad={ncp}: exact; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms (CUDA events); "
          f"moves {n_bytes} bytes, {adds} adds")
    return ncp, e, k_ms, p_ms, n_bytes, adds


def phase_packed_host(device, g, c_res, r1, r2):
    """Slice 6's packed backend over a host graph: ``MCMCColorer(g,
    backend="packed")`` on phase 11's ER(100k, 0.01) host graph.  Its A,
    built on the card from the ELL (n_pad 131,072), must equal the
    resident A word for word on the real rows (a column's word and bit do
    not depend on n_pad) and be 0 elsewhere.  Beside phase 11's K2 and K1
    chains (``r2``, ``r1``).  Returns (K1 launches, the shape's K1 row)."""
    import torch

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.models.base import check_coloring
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
    from mcmc_colorer_tpu_torch.ops import packed_nc as k1

    def per_sweep(r):
        return r.extra["chain_seconds"] / max(r.extra["sweeps"], 1) * 1e3

    params = MCMCParams(n_colors=c_res.params.n_colors, proposal=ProposalKind.BALANCE_DYNAMIC,
                        tailcut=True)
    colorer = MCMCColorer(g, params, backend="packed", device=device)
    a, ra = colorer._adj, c_res.adj
    nr, nw = ra.shape
    _require(torch.equal(a[:nr, :nw], ra) and not a[nr:].any() and not a[:, nw:].any(),
             "the packed A built from the ELL differs from the resident A")
    colorer.run(seed=5)  # warm-up
    k1.launches = 0
    r = colorer.run(seed=5)
    launches = k1.launches
    valid = check_coloring(g, r.colors)
    st = colorer.adj_stats
    print(
        f"phase 18 packed backend ER({BENCH_N}, {BENCH_P}) host graph: ELL "
        f"[{colorer.ell.n_pad}, {colorer.ell.d_pad}], A [{a.shape[0]}, {a.shape[1]}] built "
        f"on the card from it in {st['build_s']:.3f} s ("
        + ("completeness check skipped: the hash host graph is certified simple"
           if g.simple_certified else f"completeness check {st['check_s']:.3f} s")
        + "), "
        f"setup {colorer.setup_seconds:.3f} s; equals the resident A [{nr}, {nw}] on the "
        f"real rows, 0 elsewhere; warm: {r.iterations} iterations, {r.extra['sweeps']} "
        f"sweeps, {per_sweep(r):.3f} ms/sweep (phase 11: K2 chain {per_sweep(r2):.3f}, "
        f"resident K1 chain {per_sweep(r1):.3f}), tailcut rounds "
        f"{r.extra['tailcut_rounds']}, run {r.duration_ms / 1e3:.3f} s; K1 launches "
        f"{launches}; valid {valid}, final conflicts {r.extra['final_conflicts']}"
    )
    _require(launches == r.extra["sweeps"] > 0,
             f"packed backend: {launches} K1 launches in {r.extra['sweeps']} sweeps")
    _require(valid and r.extra["final_conflicts"] == 0, "packed backend: invalid colouring")
    gen = torch.Generator(device=device)
    gen.manual_seed(18)
    shape = _k1_timed(k1, a, g.n, params.n_colors, gen, "host-graph packed chain", 18)
    del colorer, a
    return launches, shape


def phase_hastings_xla(device, g):
    """The chains the card had not run: ``MCMCColorer`` with Hastings (the
    generic loop, K2 a sweep, the reverse proposal over the ELL),
    ``ResidentMCMCColorer`` with Hastings (K1 for the sweep and for the
    star colouring's NC) and ``MCMCColorer(backend="xla")`` (the plain
    versions), each 30 iterations at most on ER(100k, 0.01), tailcut on,
    each valid.  Returns (K2 launches, K1 launches)."""
    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.models.base import check_coloring
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
    from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer
    from mcmc_colorer_tpu_torch.ops import packed_nc as k1
    from mcmc_colorer_tpu_torch.ops import resample as k2

    hastings = dict(hastings=True, lambda_=25.0)
    runs = {}
    for name, make, kw in (
        ("MCMCColorer Hastings (K2)", lambda p: MCMCColorer(g, p, device=device), hastings),
        ("ResidentMCMCColorer Hastings (K1)",
         lambda p: ResidentMCMCColorer(BENCH_N, BENCH_P, 0, params=p, device=device),
         hastings),
        ("MCMCColorer backend xla", lambda p: MCMCColorer(g, p, backend="xla", device=device),
         {}),
    ):
        p = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC,
                       tailcut=True, max_iterations=30, **kw)
        k1.launches = k2.launches = 0
        t0 = time.perf_counter()
        r = make(p).run(seed=7)
        wall = time.perf_counter() - t0
        runs[name] = (k2.launches, k1.launches)
        x = r.extra
        valid = check_coloring(g, r.colors)
        print(f"phase 19 {name}: iterations {r.iterations}, conflict trace "
              f"{list(map(int, r.conflict_trace[:4]))}...{int(r.conflict_trace[-1])}, tailcut "
              f"rounds {x['tailcut_rounds']}, run {r.duration_ms / 1e3:.3f} s (wall "
              f"{wall:.3f} s); K2 launches {k2.launches}, K1 launches {k1.launches}; valid "
              f"{valid}, final conflicts {x['final_conflicts']}")
        _require(valid and x["final_conflicts"] == 0, f"{name}: invalid colouring")
    l2, _ = runs["MCMCColorer Hastings (K2)"]
    _, l1 = runs["ResidentMCMCColorer Hastings (K1)"]
    _require(l2 > 0 and l1 > 0, "the Hastings chains launched no kernel")
    _require(runs["MCMCColorer backend xla"][0] == 0, "the xla backend launched K2")
    return l2, l1



class _LaunchShapes:
    """Sorts K2's and K3's launches by (tag, shape) while main paths run,
    and keeps each shape's first inputs, so that the kernel can be held
    against its plain version, and timed, on inputs a main path gave it
    (``check``).  It wraps the launching functions the wrappers call
    (``resample_sweep_cuda``, ``first_fit_cuda``) and restores them on
    exit; a call's launches are the rise of the wrapper's own count over
    it, so a call that returns without launching counts none.  ``tag``
    names the run."""

    def __init__(self):
        from mcmc_colorer_tpu_torch.ops import firstfit as k3
        from mcmc_colorer_tpu_torch.ops import resample as k2

        self.mods = {"K2": (k2, "resample_sweep_cuda"), "K3": (k3, "first_fit_cuda")}
        self.seen = {"K2": {}, "K3": {}}  # key -> [launches, inputs]
        self.tag = ""

    def __enter__(self):
        import torch

        k2_orig, k3_orig = (getattr(m, f) for m, f in self.mods.values())
        self.orig = {"K2": k2_orig, "K3": k3_orig}

        k2_mod, k3_mod = (m for m, _ in self.mods.values())

        def record(kernel, key, inputs, launched):
            # ``launched`` is the wrapper's own count's rise over the call
            # (0 where the call returned without a launch)
            if not launched:
                return
            rec = self.seen[kernel].setdefault((self.tag, *key), [0, None])
            if rec[1] is None:
                rec[1] = tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in inputs)
            rec[0] += launched

        def one(x):
            # the chain core hands one chain's runs over as [1, ...]: the
            # same launch as the chainless call, which the checks make
            return x[0] if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] == 1 else x

        def k2_launch(neighbors, colors, cur, taboo, row0, unif, p_eff, eps, params,
                      self_ids=None, **kw):
            before = k2_mod.launches
            out = k2_orig(neighbors, colors, cur, taboo, row0, unif, p_eff, eps, params,
                          self_ids, **kw)
            if colors.dim() == 2 and colors.shape[0] > 1:
                return out  # a chain axis: _ChainShapes holds those launches
            if colors.dim() == 2:
                colors, cur, taboo, unif, p_eff = map(one, (colors, cur, taboo, unif, p_eff))
            record("K2", (tuple(neighbors.shape), colors.shape[-1], params.n_colors,
                          self_ids is not None),
                   (neighbors, colors, cur, taboo, row0, unif, p_eff, params, self_ids),
                   k2_mod.launches - before)
            return out

        def k3_launch(neighbors, colors, allow, n_colors, cur=None):
            before = k3_mod.launches
            out = k3_orig(neighbors, colors, allow, n_colors, cur)
            if colors.dim() == 2 and colors.shape[0] > 1:
                return out
            if colors.dim() == 2:
                colors, cur = one(colors), one(cur)
            record("K3", (tuple(neighbors.shape), colors.shape[-1], n_colors, cur is not None),
                   (neighbors, colors, allow, n_colors, cur), k3_mod.launches - before)
            return out

        for (m, f), fn in zip(self.mods.values(), (k2_launch, k3_launch)):
            setattr(m, f, fn)
        return self

    def __exit__(self, *exc):
        for k, (m, f) in self.mods.items():
            setattr(m, f, self.orig[k])

    def check(self, phase: int, plain_runs: int):
        """Each recorded shape: K2 under the CDF-boundary rule with exact
        conflicts (in its regime and in L2) and K3 exactly, then timed with
        its plain version.  Returns (K2 rows, K3 rows, boundary fraction,
        max |qstar error|, K3's max abs error); each row carries its
        launches."""
        import torch

        k2, k3 = self.mods["K2"][0], self.mods["K3"][0]
        k2_rows, k3_rows, frac, qerr, err3 = [], [], 0.0, 0.0, 0
        for (tag, shape, n_ids, n_colors, own), (n, a) in self.seen["K2"].items():
            neigh, colors, cur, taboo, row0, unif, p_eff, params, self_ids = a
            args = (neigh, colors, cur, taboo, row0, unif, p_eff)
            label = f"{tag} [{shape[0]}, {shape[1]}]" + (" frontier" if own else f" row0 {row0}")
            f, e = _k2_both(k2, args, params, label, phase=phase, self_ids=self_ids)
            row = _k2_timed(k2, args, params, label, plain_runs=plain_runs, phase=phase,
                            self_ids=self_ids)
            k2_rows.append({**row, "launches": n, "n_colors": n_colors})
            frac, qerr = max(frac, f), max(qerr, e)
        for (tag, shape, n_ids, n_colors, own), (n, a) in self.seen["K3"].items():
            neigh, colors, allow, _, cur = a
            label = f"{tag} [{shape[0]}, {shape[1]}] n_colors={n_colors}" + (
                " allow+cur" if cur is not None else "")
            e = _k3_check(k3, neigh, colors, allow, n_colors, cur, label, phase=phase)
            err3 = max(err3, e)
            k_ms = _median_ms(lambda: k3.first_fit_cuda(neigh, colors, allow, n_colors, cur))
            p_ms = _median_ms(lambda: k3.first_fit_plain(neigh, colors, allow, n_colors, cur),
                              runs=plain_runs)
            slots = int((neigh < colors.shape[0]).sum())
            n_bytes = (_nbytes(neigh, allow) + _gathered_bytes(neigh, colors) + shape[0] * 4
                       + (_nbytes(cur) if cur is not None else 0))
            print(f"phase {phase} K3 {label}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
                  f"(median of {TIMED_RUNS}, plain of {plain_runs}, CUDA events); {n} "
                  f"launches; {slots} neighbour slots, moves {n_bytes} bytes")
            k3_rows.append({"shape": label, "rows": shape[0], "d_pad": shape[1],
                            "n_colors": n_colors, "launches": n, "max_abs_err": e,
                            "ms": k_ms, "plain_ms": p_ms, "bytes": n_bytes, "ops": slots})
        torch.cuda.empty_cache()
        return k2_rows, k3_rows, frac, qerr, err3


def _run_colorer(make, g, label, phase, *, seed=41, check=True):
    """Build and run one colorer: (result, run seconds, peak device bytes
    of build and run above what was allocated before, K2 and K3
    launches); prints a line and requires a valid colouring."""
    import torch

    from mcmc_colorer_tpu_torch.models.base import check_coloring
    from mcmc_colorer_tpu_torch.ops import firstfit as k3
    from mcmc_colorer_tpu_torch.ops import resample as k2

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k2.launches = k3.launches = 0
    t0 = time.perf_counter()
    c = make()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    r = c.run(seed=seed)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0 - setup_s
    peak = torch.cuda.max_memory_allocated() - base
    l2, l3 = k2.launches, k3.launches
    x = r.extra or {}
    valid = check_coloring(g, r.colors) if check else None
    rounds = x.get("sweeps", x.get("rounds", r.iterations))
    print(f"phase {phase} {label}: setup {setup_s:.3f} s, run {run_s:.3f} s; iterations "
          f"{r.iterations}, {rounds} sweeps or rounds "
          f"({run_s / max(rounds, 1) * 1e3:.3f} ms each); colours used {r.used_colors}; "
          + (f"chain {x['chain_seconds']:.3f} s ({x['chain_seconds'] / max(x['sweeps'], 1) * 1e3:.3f} "
             f"ms/sweep), tailcut rounds {x['tailcut_rounds']} {x['tailcut_seconds']:.3f} s; "
             if "sweeps" in x else "")
          + (f"full sweeps {x['full_sweeps']}, frontier iterations {x['frontier_iterations']}, "
             f"tailcut rounds {x['tailcut_rounds']}; " if "full_sweeps" in x else "")
          + f"K2 launches {l2}, K3 launches {l3}; peak device memory {peak} bytes above the "
          f"{base} allocated before; valid {valid}, final conflicts "
          f"{x.get('final_conflicts', 'n/a')}")
    if check:
        _require(valid and x.get("final_conflicts", 0) == 0, f"{label}: invalid colouring")
    return c, r, run_s, peak, l2, l3


def _sweep_times(ell, params, device, seed):
    """(CUDA-event ms, device ms) of one ``_sweep_pallas_fused`` over
    ``ell`` (K2 once a rectangle) from a random state: the sweep as the
    chain runs it, without the host read that ends a do-while body."""
    import torch

    from mcmc_colorer_tpu_torch.measure_kernels import _device_ms
    from mcmc_colorer_tpu_torch.models import mcmc as tm

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    colors = torch.randint(0, params.n_colors, (ell.n_pad,), generator=gen, device=device,
                           dtype=torch.int32)
    colors = torch.where(ell.node_mask, colors, params.n_colors)
    taboo = torch.zeros_like(colors)
    unif = torch.rand((ell.n_pad,), generator=gen, device=device)
    p_eff = tm._p_eff_of(colors, params, ell.n_nodes, ell.node_mask)
    args = (colors[None], taboo[None], unif[None], p_eff[None])  # the core's one chain

    def sweep():
        return tm._sweep_pallas_fused(ell, params, 0, *args)

    return _median_ms(sweep), _device_ms(sweep, TIMED_RUNS)


def phase_config4_bucketed(device, g, r_flat, gff_flat):
    """Slice 7 at BASELINE config 4 (phase 10's BA(50k, 8) graph): every
    device colorer with ``layout="bucketed"``, beside the flat layout:
    MCMCColorer (K2 a degree class a sweep, K3 tailcut; seed 41), once with
    Hastings, ActiveMCMCColorer, GreedyFF, VFF and Luby, full and frontier.
    The chain must launch K2 exactly once a class a sweep; GreedyFF with K3
    and with its plain version, and full and frontier, give identical
    colours.  Every K2 and K3 shape the bucketed runs launched is held
    against its plain version and timed (``_LaunchShapes``).  Returns
    (K2 rows, K3 rows, boundary fraction, max |qstar error|, K3 error)."""
    import numpy as np

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer
    from mcmc_colorer_tpu_torch.models.luby import LubyColorer
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer, choose_block_size
    from mcmc_colorer_tpu_torch.models.mcmc_active import ActiveMCMCColorer
    from mcmc_colorer_tpu_torch.models.vff import VFFColorer

    t_phase = time.perf_counter()
    params = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC,
                        tailcut=True)
    fx = r_flat.extra
    print(f"phase 20 config4 flat MCMC (phase 10): {fx['sweeps']} sweeps, chain "
          f"{fx['chain_seconds']:.3f} s ({fx['chain_seconds'] / max(fx['sweeps'], 1) * 1e3:.3f} "
          f"ms/sweep), run {r_flat.duration_ms / 1e3:.3f} s; flat GreedyFF (phase 10) "
          f"{gff_flat.iterations} rounds, run {gff_flat.duration_ms / 1e3:.3f} s")
    rec = _LaunchShapes()
    with rec:
        rec.tag = "config-4 bucketed MCMC"
        c, r, run_s, _, l2, _ = _run_colorer(
            lambda: MCMCColorer(g, params, backend="pallas", layout="bucketed", device=device),
            g, "config4 bucketed MCMC (K2, tailcut K3)", 20)
        bell = c.ell
        d_flat = _round_up(g.max_degree, 128)
        n_flat = _round_up(g.n, choose_block_size(g.n, params.n_colors))
        real_ids = sum(s.n_real * s.d_pad for s in bell.slices)
        print(f"phase 20 config4 bucketed layout: n_pad {bell.n_pad}, slices "
              f"{[(s.h_pad, s.d_pad, s.n_real) for s in bell.slices]}, gather_elements "
              f"{bell.gather_elements} against the flat n_pad · d_pad {n_flat * d_flat} "
              f"([{n_flat}, {d_flat}], phase 10's MCMCColorer) and {_round_up(g.n, 128) * d_flat} "
              f"at 128-row padding; a sweep reads {real_ids} ids (flat {g.n * d_flat}, "
              f"{g.n * d_flat / real_ids:.2f}x); setup {c.setup_seconds:.3f} s")
        _require(l2 == r.extra["sweeps"] * len(bell.slices),
                 f"config 4 bucketed: {l2} K2 launches for {r.extra['sweeps']} sweeps of "
                 f"{len(bell.slices)} slices")
        rec.tag = "config-4 bucketed Hastings"
        hp = params.replace(hastings=True, lambda_=25.0, max_iterations=30)
        _run_colorer(lambda: MCMCColorer(g, hp, layout="bucketed", device=device), g,
                     "config4 bucketed MCMC Hastings (K2, generic loop)", 20)
        for layout in ("flat", "bucketed"):
            rec.tag = f"config-4 {layout} frontier MCMC"
            _run_colorer(lambda: ActiveMCMCColorer(g, params, layout=layout, device=device), g,
                         f"config4 {layout} ActiveMCMCColorer", 20)
        colours = {}
        for layout in ("flat", "bucketed"):
            for active in (False, True):
                name = "frontier" if active else "full"
                for kind, make in (
                    ("GreedyFF", lambda: GreedyFFColorer(g, active=active, layout=layout,
                                                         device=device)),
                    ("VFF", lambda: VFFColorer(g, active=active, layout=layout,
                                               device=device)),
                    ("Luby", lambda: LubyColorer(g, active=active, layout=layout,
                                                 device=device)),
                ):
                    if (kind, layout, active) == ("GreedyFF", "flat", False):
                        continue  # phase 10's run
                    rec.tag = f"config-4 {layout} {kind} {name}"
                    _, res, *_ = _run_colorer(make, g, f"config4 {layout} {kind} {name}", 20,
                                              seed=5)
                    colours[(kind, layout, name)] = res.colors
    flat_ell = MCMCColorer(g, params, backend="pallas", device=device).ell
    times = {name: _sweep_times(e, params, device, 20)
             for name, e in (("flat", flat_ell), ("bucketed", bell), ("flat again", flat_ell),
                             ("bucketed again", bell))}
    print("phase 20 config4 one K2 sweep from one random state, flat (one launch over "
          f"[{g.n}, {flat_ell.d_pad}]) and bucketed ({len(bell.slices)} launches), in turns: "
          + "; ".join(f"{k} {ev:.3f} ms by events, {dv:.3f} ms device"
                      for k, (ev, dv) in times.items()))
    del flat_ell
    t_plain = time.perf_counter()
    plain = GreedyFFColorer(g, backend="xla", layout="bucketed", device=device).run()
    same = {
        "bucketed K3 / plain": np.array_equal(colours[("GreedyFF", "bucketed", "full")],
                                             plain.colors),
        "bucketed full / frontier": np.array_equal(colours[("GreedyFF", "bucketed", "full")],
                                                  colours[("GreedyFF", "bucketed", "frontier")]),
        "flat full / frontier": np.array_equal(gff_flat.colors,
                                              colours[("GreedyFF", "flat", "frontier")]),
    }
    print(f"phase 20 config4 GreedyFF identical colours: {same} (plain run "
          f"{time.perf_counter() - t_plain:.3f} s)")
    _require(all(same.values()), f"config 4 GreedyFF colourings differ: {same}")
    print(f"phase 20 K2 launches by shape {[(k[0], k[1], n) for k, (n, _) in rec.seen['K2'].items()]}; "
          f"K3 {[(k[0], k[1], k[3], n) for k, (n, _) in rec.seen['K3'].items()]}")
    out = rec.check(20, plain_runs=3)
    print(f"phase 20: {time.perf_counter() - t_phase:.3f} s")
    return out


def phase_ba1m_bucketed(device):
    """Slice 7 at BA(1M, 8), seed 4, from the native sampler, nCol = max
    degree: the bucketed MCMCColorer (K2, tailcut) and the bucketed
    GreedyFF (K3), full loops; both valid; setup, chain and tailcut
    seconds, peak device bytes and the flat rectangle the layout avoids.
    Every K2 and K3 shape they launched is held and timed."""
    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.graph.generate import barabasi_albert
    from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    g = barabasi_albert(BA1M_N, CONFIG4_M, seed=CONFIG4_SEED, use_native=True)
    gen_s = time.perf_counter() - t0
    flat_bytes = _round_up(g.n, 128) * _round_up(g.max_degree, 128) * 4
    print(f"phase 21 BA({BA1M_N}, {CONFIG4_M}) seed {CONFIG4_SEED}, native sampler: n={g.n} "
          f"m={g.n_edges} max_degree={g.max_degree}, gen {gen_s:.3f} s; the flat ELL it "
          f"avoids: [{_round_up(g.n, 128)}, {_round_up(g.max_degree, 128)}] int32, "
          f"{flat_bytes} bytes")
    params = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC,
                        tailcut=True)
    rec = _LaunchShapes()
    with rec:
        rec.tag = "BA(1M, 8) bucketed MCMC"
        c, r, _, _, l2, _ = _run_colorer(
            lambda: MCMCColorer(g, params, backend="pallas", layout="bucketed", device=device),
            g, f"BA({BA1M_N}, {CONFIG4_M}) bucketed MCMC (K2, tailcut K3)", 21, seed=41)
        bell = c.ell
        print(f"phase 21 layout: n_pad {bell.n_pad}, slices "
              f"{[(s.h_pad, s.d_pad, s.n_real) for s in bell.slices]}, gather_elements "
              f"{bell.gather_elements} ({bell.gather_elements * 4} bytes), setup (relabel, "
              f"host build, copy) {c.setup_seconds:.3f} s")
        _require(l2 == r.extra["sweeps"] * len(bell.slices),
                 f"BA(1M, 8): {l2} K2 launches for {r.extra['sweeps']} sweeps of "
                 f"{len(bell.slices)} slices")
        del c
        rec.tag = "BA(1M, 8) bucketed GreedyFF"
        _run_colorer(lambda: GreedyFFColorer(g, layout="bucketed", device=device), g,
                     f"BA({BA1M_N}, {CONFIG4_M}) bucketed GreedyFF (K3)", 21)
    # timed outside the recorder: these launches are no main path's
    ev, dv = _sweep_times(bell, params, device, 21)
    print(f"phase 21 one K2 sweep from one random state ({len(bell.slices)} launches): "
          f"{ev:.3f} ms by events, {dv:.3f} ms device")
    del bell
    out = rec.check(21, plain_runs=1)
    print(f"phase 21: {time.perf_counter() - t_phase:.3f} s")
    return out


# ------------------------------- slice 8 -------------------------------

# phase 22's palette: numColRatio 4 (287 colours at max degree 1150), where
# the stepped chain needs tens of sweeps (33 on the H100), so the halfway
# checkpoint falls well inside the run (at the max degree it ends in 4)
STEPPED_RATIO = 4.0
ENSEMBLE_CHAINS, BUCKETED_CHAINS, RESIDENT_CHAINS = 8, 4, 4


class _ChainShapes:
    """Counts the launches of K1, K2 and K3 with a chain axis ([C, n]
    colours) by (kernel, tag, shape) while runs go, and keeps each shape's
    first inputs (the colour-dependent ones cloned; the adjacency or ELL
    is shared and never changes), so that each batched launch a run made
    can be held against the plain version and against C single launches
    on that run's own data, and timed (``check``).  A call's launches are
    the rise of the wrapper's own count over it."""

    def __init__(self):
        from mcmc_colorer_tpu_torch.ops import firstfit as k3
        from mcmc_colorer_tpu_torch.ops import packed_nc as k1
        from mcmc_colorer_tpu_torch.ops import resample as k2

        self.mods = {"K1": (k1, "packed_nc_cuda"), "K2": (k2, "resample_sweep_cuda"),
                     "K3": (k3, "first_fit_cuda")}
        self.seen = {k: {} for k in self.mods}
        self.tag = ""

    def __enter__(self):
        import torch

        self.orig = {k: getattr(m, f) for k, (m, f) in self.mods.items()}

        def wrap(kernel, mod, orig):
            def call(*a, **kw):
                before = mod.launches
                out = orig(*a, **kw)
                # an ensemble's launches: C > 1 chains (one chain's runs
                # pass [1, n], the chainless launch, held by _LaunchShapes)
                if a[1].dim() == 2 and a[1].shape[0] > 1 and mod.launches > before:
                    rec = self.seen[kernel].setdefault(
                        (self.tag, tuple(a[0].shape), tuple(a[1].shape)), [0, None])
                    if rec[1] is None:
                        rec[1] = (a[0],) + tuple(
                            x.clone() if isinstance(x, torch.Tensor) else x for x in a[1:])
                    rec[0] += mod.launches - before
                return out
            return call

        for k, (m, f) in self.mods.items():
            setattr(m, f, wrap(k, m, self.orig[k]))
        return self

    def __exit__(self, *exc):
        for k, (m, f) in self.mods.items():
            setattr(m, f, self.orig[k])

    def launches(self, kernel: str) -> int:
        return sum(n for n, _ in self.seen[kernel].values())

    def check(self, phase: int) -> dict:
        """Every recorded shape held and timed: {kernel: rows}, and the K2
        boundary fraction and qstar error."""
        out = {"K1": [], "K2": [], "K3": [], "frac": 0.0, "qerr": 0.0}
        for kernel, fn in (("K1", _k1_batched), ("K2", _k2_batched), ("K3", _k3_batched)):
            for (tag, nshape, cshape), (n, args) in self.seen[kernel].items():
                label = f"{tag} {list(cshape)} x {list(nshape)}"
                row = fn(self.mods[kernel][0], args, label, phase)
                out["frac"] = max(out["frac"], row.pop("frac", 0.0))
                out["qerr"] = max(out["qerr"], row.pop("qerr", 0.0))
                out[kernel].append({**row, "launches": n})
        return out


def _once_ms(fn):
    """(result, CUDA-event ms) of one call of ``fn``: the plain versions
    are timed on the call their check makes (hundreds of ms to seconds at
    these shapes, so one call is far above the timer's resolution)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _pair_times(batched, singles, label, phase, plain_ms):
    """CUDA-event and device times of one batched launch and of its C
    single launches, beside the plain version's ``plain_ms``."""
    from mcmc_colorer_tpu_torch.measure_kernels import _device_ms

    t = {"ms": _median_ms(batched), "singles_ms": _median_ms(singles),
         "device_ms": _device_ms(batched, TIMED_RUNS),
         "singles_device_ms": _device_ms(singles, TIMED_RUNS), "plain_ms": plain_ms}
    print(f"phase {phase} {label}: batched {t['ms']:.3f} ms, {t['device_ms']:.3f} device; "
          f"the chains' single launches {t['singles_ms']:.3f} ms, "
          f"{t['singles_device_ms']:.3f} device; plain {plain_ms:.3f} ms (medians of "
          f"{TIMED_RUNS}, plain of 1, CUDA events; device time under the profiler)")
    return t


def _k2_batched(k2, args, label, phase):
    """K2 with a chain axis on a run's inputs: against its plain version
    chain by chain under ``_k2_compare``'s rule, against one launch a chain
    exactly (all four outputs), then timed."""
    import torch

    neigh, colors, cur, taboo, row0, unif, p_eff, eps, params = args[:9]
    chains = colors.shape[0]
    got = k2.resample_sweep_cuda(neigh, colors, cur, taboo, row0, unif, p_eff, eps, params)
    want, plain_ms = _once_ms(lambda: k2.resample_sweep_plain(
        neigh, colors, cur, taboo, row0, unif, p_eff, eps, params))
    per_chain = [(neigh, colors[c].contiguous(), cur[c].contiguous(), taboo[c].contiguous(),
                  row0, unif[c].contiguous(), None if p_eff is None else p_eff[c].contiguous())
                 for c in range(chains)]
    frac = qerr = 0.0
    for c, args_c in enumerate(per_chain):
        f, e = _k2_compare(k2, tuple(x[c] for x in got), tuple(x[c] for x in want), args_c,
                           params, f"{label} chain {c}", phase)
        frac, qerr = max(frac, f), max(qerr, e)
        one = k2.resample_sweep_cuda(*args_c, eps, params)
        _require(all(torch.equal(a[c], b) for a, b in zip(got[:3], one[:3]))
                 and int(got[3][c]) == int(one[3]),
                 f"K2 with a chain axis differs from chain {c}'s single launch at {label}")
    del got, want
    print(f"phase {phase} K2 {label}: every chain equal to its single launch")
    t = _pair_times(
        lambda: k2.resample_sweep_cuda(neigh, colors, cur, taboo, row0, unif, p_eff, eps,
                                       params),
        lambda: [k2.resample_sweep_cuda(*a, eps, params) for a in per_chain],
        f"K2 {label}", phase, plain_ms)
    # the ids are read once for all chains; each chain's vectors, colours
    # and outputs once
    n_bytes = sum(_k2_bytes_ops(a, params.n_colors)[0] for a in per_chain)
    n_bytes -= (chains - 1) * _nbytes(neigh)
    rows, d_pad = neigh.shape
    shape = k2.sweep_shape(colors.shape[-1], params.n_colors)
    return {"shape": label, "regime": "staged" if shape.staged else "L2", "rows": rows,
            "d_pad": d_pad, "chains": chains, "n_colors": params.n_colors, **t,
            "bytes": n_bytes, "ops": chains * rows * (d_pad + params.n_colors),
            "frac": frac, "qerr": qerr}


def _k3_batched(k3, args, label, phase):
    """K3 with a chain axis on a run's inputs: against its plain version
    and against one launch a chain, exactly; then timed."""
    import torch

    neigh, colors, allow, n_colors = args[:4]
    cur = args[4] if len(args) > 4 else None
    chains = colors.shape[0]
    got = k3.first_fit_cuda(neigh, colors, allow, n_colors, cur)
    want, plain_ms = _once_ms(lambda: k3.first_fit_plain(neigh, colors, allow, n_colors, cur))
    err = int((got - want).abs().max())
    _require(err == 0, f"K3 with a chain axis differs from its plain version at {label}: {err}")
    per_chain = [(colors[c].contiguous(), None if cur is None else cur[c].contiguous())
                 for c in range(chains)]
    for c, (col_c, cur_c) in enumerate(per_chain):
        _require(torch.equal(got[c], k3.first_fit_cuda(neigh, col_c, allow, n_colors, cur_c)),
                 f"K3 with a chain axis differs from chain {c}'s single launch at {label}")
    print(f"phase {phase} K3 {label}: exact against the plain version and the single launches")
    t = _pair_times(lambda: k3.first_fit_cuda(neigh, colors, allow, n_colors, cur),
                    lambda: [k3.first_fit_cuda(neigh, a, allow, n_colors, b) for a, b in per_chain],
                    f"K3 {label}", phase, plain_ms)
    slots = int((neigh < colors.shape[1]).sum())
    n_bytes = (_nbytes(neigh, allow) + chains * neigh.shape[0] * 4
               + sum(_gathered_bytes(neigh, a) + (_nbytes(b) if b is not None else 0)
                     for a, b in per_chain))
    return {"shape": label, "rows": neigh.shape[0], "d_pad": neigh.shape[1], "chains": chains,
            "n_colors": n_colors, "max_abs_err": err, **t, "bytes": n_bytes,
            "ops": chains * slots}


def _k1_batched(k1, args, label, phase):
    """K1 with a chain axis on a run's inputs (one shared A): against its
    plain version and against one launch a chain, exactly; then timed."""
    import torch

    adj, colors, ncp = args[:3]
    chains = colors.shape[0]
    got = k1.packed_nc_cuda(adj, colors, ncp)
    want, plain_ms = _once_ms(lambda: k1.packed_nc_reference(adj, colors, ncp))
    err = int((got - want).abs().max())
    del want
    _require(err == 0, f"K1 with a chain axis differs from its plain version at {label}: {err}")
    per_chain = [colors[c].contiguous() for c in range(chains)]
    for c, col_c in enumerate(per_chain):
        _require(torch.equal(got[c], k1.packed_nc_cuda(adj, col_c, ncp)),
                 f"K1 with a chain axis differs from chain {c}'s single launch at {label}")
    del got
    print(f"phase {phase} K1 {label}: exact against the plain version and the single launches")
    t = _pair_times(lambda: k1.packed_nc_cuda(adj, colors, ncp),
                    lambda: [k1.packed_nc_cuda(adj, a, ncp) for a in per_chain],
                    f"K1 {label}", phase, plain_ms)
    n_bytes = _nbytes(adj, colors) + chains * adj.shape[0] * ncp * 4
    return {"shape": label, "n_col_pad": ncp, "chains": chains, "max_abs_err": err, **t,
            "bytes": n_bytes, "ops": _k1_adds(adj, colors, ncp)}


def _k1_adds(adj, colors, ncp) -> int:
    """K1's adds on these inputs: for each chain, the set bits of A (or of
    a strip of A) in the columns whose colour counts (in [0, ncp))."""
    from mcmc_colorer_tpu_torch.models.mcmc_resident import _pack_mask
    from mcmc_colorer_tpu_torch.ops.hashgen import popcount32

    adds = 0
    for a in colors if colors.dim() == 2 else colors[None]:
        mask = _pack_mask((a >= 0) & (a < ncp), adj.shape[1])
        for r0 in range(0, adj.shape[0], 8192):
            adds += int(popcount32(adj[r0:r0 + 8192] & mask).sum())
    return adds


def _k1_single(k1, args, label, phase):
    """K1 on one colour vector of a run's inputs: exactly against its plain
    version, then timed by CUDA events and by device time."""
    from mcmc_colorer_tpu_torch.measure_kernels import _device_ms

    adj, colors, ncp = args
    got = k1.packed_nc_cuda(adj, colors, ncp)
    want, plain_ms = _once_ms(lambda: k1.packed_nc_reference(adj, colors, ncp))
    err = int((got - want).abs().max())
    del got, want
    _require(err == 0, f"K1 differs from its plain version at {label}: {err}")
    ms = _median_ms(lambda: k1.packed_nc_cuda(adj, colors, ncp))
    dev_ms = _device_ms(lambda: k1.packed_nc_cuda(adj, colors, ncp), TIMED_RUNS)
    print(f"phase {phase} K1 {label}: exact against the plain version; {ms:.3f} ms, "
          f"{dev_ms:.3f} device; plain {plain_ms:.3f} ms (median of {TIMED_RUNS}, plain of 1, "
          f"CUDA events; device time under the profiler)")
    return {"shape": label, "n_col_pad": ncp, "chains": 1, "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            "bytes": _nbytes(adj, colors) + adj.shape[0] * ncp * 4,
            "ops": _k1_adds(adj, colors, ncp)}


class _K1Shapes:
    """Counts K1's launches by (A or strip shape, colours shape) while the
    runs of one path go, whatever their chain count, and keeps each
    shape's first inputs (the colours cloned; A or the strip is shared and
    never changes), so that each launch shape the path made is held
    exactly against ``packed_nc_reference`` on its own data and timed
    (``check``: ``_k1_batched`` with a chain axis, ``_k1_single``
    without), once a shape: the plain version takes seconds there.  The
    rows are labelled ``label``; the runs' ``tag`` (set by
    ``_sharded_run``) does not split them.  A call's launches are the
    rise of the wrapper's own count over it."""

    def __init__(self, label: str):
        from mcmc_colorer_tpu_torch.ops import packed_nc as k1

        self.k1, self.seen, self.label, self.tag = k1, {}, label, ""

    def __enter__(self):
        k1 = self.k1
        self.orig = orig = k1.packed_nc_cuda

        def call(packed, colors, n_col_pad, **kw):
            before = k1.launches
            out = orig(packed, colors, n_col_pad, **kw)
            if k1.launches > before:
                key = (tuple(packed.shape), tuple(colors.shape), n_col_pad)
                rec = self.seen.setdefault(key, [0, None])
                if rec[1] is None:
                    rec[1] = (packed, colors.clone(), n_col_pad)
                rec[0] += k1.launches - before
            return out

        k1.packed_nc_cuda = call
        return self

    def __exit__(self, *exc):
        self.k1.packed_nc_cuda = self.orig

    def launches(self) -> int:
        return sum(n for n, _ in self.seen.values())

    def check(self, phase: int) -> list:
        rows = []
        for (ashape, cshape, _), (n, args) in self.seen.items():
            label = f"{self.label} {list(cshape)} x {list(ashape)}"
            batched = len(cshape) == 2 and cshape[0] > 1
            if len(cshape) == 2 and not batched:
                # one chain's [1, K]: the chainless launch
                args = (args[0], args[1][0], args[2])
            row = (_k1_batched if batched else _k1_single)(self.k1, args, label, phase)
            rows.append({**row, "launches": n})
        return rows


def _one_chain_syncs(graph, n_pad, n_nodes, params, block, sweep, label, phase, seed=5,
                     ell=None, node_mask=None, bodies=3):
    """The chain core at one chain (C = 1) reads the host once a body: do-
    while bodies over ``graph`` with ``sweep`` (after one that warms up)
    under the sync debug mode, and with ``ell`` a tailcut round (K3).  A
    copy of a host mask to the card would show here as a second sync."""
    from functools import partial

    import numpy as np

    from mcmc_colorer_tpu_torch.models import mcmc as tm
    from mcmc_colorer_tpu_torch.utils.rng import ChainSources, TorchUniformSource

    dev = node_mask.device if node_mask is not None else ell.node_mask.device
    sources = ChainSources([TorchUniformSource(seed, 0, dev)], dev)
    st = tm._chain_init(n_pad, n_nodes, params, sources, dev, node_mask=node_mask)
    body = partial(tm._chain_body, params=params, block=block, n_nodes=n_nodes,
                   sources=sources, sweep=sweep)
    run1 = np.ones(1, bool)
    sites = []
    for _ in range(bodies + 1):
        st, got = _host_syncs(lambda: body(graph, st, run1))
        sites.append(got)
    tc_sites = []
    if ell is not None:
        tc = tm.TailcutState(tm._tailcut_init(ell, st.colors[0], params=params)[0][None],
                             st.conf_last.copy(), np.zeros(1, np.int64), np.zeros(1, bool))
        _, tc_sites = _host_syncs(lambda: tm._tailcut_body(ell, tc, run1, sources,
                                                           params=params))
    warm, sites = sites[0], sites[1:]
    print(f"phase {phase} {label} host reads at one chain: warm-up body {warm}; bodies "
          f"{[len(x) for x in sites]} ({sorted({y for x in sites for y in x})})"
          + (f", a tailcut round {len(tc_sites)} {tc_sites}" if ell is not None else ""))
    _require(all(len(x) == 1 for x in sites) and (ell is None or len(tc_sites) == 1),
             f"{label}: a body and a tailcut round of one chain must read the host once: "
             f"{sites}, {tc_sites}")


def phase_stepped(device, g, seed=5):
    """Slice 8, phase 22: the stepped chain (``SteppedMCMC``, K2 a body
    and K3 in its tailcut) on phase 11's ER(100k, 0.01) host graph at
    numColRatio ``STEPPED_RATIO``, balance-dynamic, tailcut, seed 5: a run
    in segments of 4 with a checkpoint; a second instance steps half of
    that run's sweeps, saves, and a fresh one resumes and must end equal
    (colours, iterations, final conflicts); ``inspect`` on the card equals
    it on a CPU copy of the state; ``DebugAttach`` with scripted streams
    (``p free``, ``e epsilon 0.05``, ``c``, then ``q``) reaches the next
    segment with the new ε; ``MCMCColorer`` under ``MCMC_COLORER_TRACE=1``
    gives the untraced colouring and one TRACE line a segment; a stepped
    body, a do-while body and a tailcut round of the chain core at one
    chain read the host once each.  The K2 and K3 launches of the
    segmented run and of the traced run, each run under its own tag, are
    held and timed by shape (``_LaunchShapes``).  Returns (K2 rows, K3
    rows, boundary fraction, max |qstar error|, K3 error)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind, default_n_colors
    from mcmc_colorer_tpu_torch.models.base import check_coloring
    from mcmc_colorer_tpu_torch.models import mcmc as tm
    from mcmc_colorer_tpu_torch.models.chain_api import ChainState, SteppedMCMC
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
    from mcmc_colorer_tpu_torch.ops import firstfit as k3
    from mcmc_colorer_tpu_torch.ops import resample as k2
    from mcmc_colorer_tpu_torch.utils.dbg import DebugAttach

    params = MCMCParams(n_colors=default_n_colors(g.max_degree, STEPPED_RATIO),
                        proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    t0 = time.perf_counter()
    shapes = _LaunchShapes()
    with tempfile.TemporaryDirectory() as td:
        shapes.tag = "stepped"
        a = SteppedMCMC(g, params, backend="pallas", device=device)
        ck = os.path.join(td, "stepped.npz")
        k2.launches = k3.launches = 0
        t1 = time.perf_counter()
        with shapes:  # the segmented run alone: the kernels line's stepped row
            ra = a.run(seed=seed, segment=4, checkpoint_path=ck)
            torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        l2, l3 = k2.launches, k3.launches
        valid = check_coloring(g, ra.colors)
        print(f"phase 22 stepped ER({BENCH_N}, {BENCH_P}) n_colors={params.n_colors} (ratio "
              f"{STEPPED_RATIO}) seed {seed}, segments of 4 with a checkpoint: {ra.iterations} "
              f"sweeps, tailcut rounds {ra.extra['tailcut_rounds']}, run {run_s:.3f} s "
              f"({run_s / max(ra.iterations, 1) * 1e3:.3f} ms a sweep with the tailcut); K2 "
              f"launches {l2}, K3 launches {l3}; valid {valid}, final conflicts "
              f"{ra.extra['final_conflicts']}")
        _require(valid and ra.extra["final_conflicts"] == 0, "phase 22: invalid colouring")
        _require(ra.iterations >= 4, f"phase 22: the run took {ra.iterations} sweeps, not >= 4")
        _require(l2 == ra.iterations and l3 >= (ra.extra["tailcut_rounds"] > 0),
                 f"phase 22: {l2} K2 launches in {ra.iterations} sweeps")
        _require(a.load_checkpoint(ck).iteration == ra.iterations,
                 "phase 22: the last checkpoint is not the run's last state")
        half = ra.iterations // 2
        b = SteppedMCMC(g, params, backend="pallas", device=device)
        st = b.step(b.init_state(seed), n_steps=half)
        ck2 = os.path.join(td, "half.npz")
        b.save_checkpoint(st, ck2)
        rc = SteppedMCMC(g, params, backend="pallas", device=device).run(seed=seed,
                                                                          resume_from=ck2)
        same = (np.array_equal(rc.colors, ra.colors) and rc.iterations == ra.iterations
                and rc.extra["final_conflicts"] == ra.extra["final_conflicts"])
        print(f"phase 22 resume: {half} steps, saved, loaded into a fresh instance: "
              f"{rc.iterations} sweeps, equal to the uninterrupted run {same}")
        _require(same, "phase 22: the resumed run differs from the uninterrupted one")
        info = b.inspect(st)
        cpu_state = ChainState(st.colors.cpu(), st.taboo.cpu(), st.rng, st.iteration,
                               st.conflicts)
        info_cpu = SteppedMCMC(g, params, backend="pallas", device="cpu").inspect(cpu_state)
        ints = [k for k, v in info.items() if isinstance(v, int)]
        same = (all(info[k] == info_cpu[k] for k in ints)
                and np.array_equal(info["histogram"], info_cpu["histogram"]))
        print(f"phase 22 inspect at iteration {info['iteration']}: "
              + ", ".join(f"{k} {info[k]}" for k in ints)
              + f", avg free {info['free_colors_avg']:.4f}; card equal to the CPU copy {same}")
        _require(same, "phase 22: inspect on the card differs from the CPU copy")
        _, sites = _host_syncs(lambda: b.step(st, n_steps=1))
        print(f"phase 22 stepped body host reads: {len(sites)} {sites}")
        _require(len(sites) == 1, f"phase 22: a stepped body read the host {len(sites)} times")
        d = SteppedMCMC(g, params.replace(tailcut=False), backend="pallas", device=device)
        seen, step = [], d.step

        def spy(state, n_steps=1, epsilon=None):
            seen.append(epsilon)
            return step(state, n_steps, epsilon=epsilon)

        d.step = spy
        out = io.StringIO()
        dbg = DebugAttach(input=iter(["p free", "e epsilon 0.05", "c", "q"]), output=out,
                          break_every=True)
        rd = d.run(seed=seed, segment=1, dbg=dbg)
        print(f"phase 22 DebugAttach: segments ran with epsilon {seen}; quit {dbg.quit} at "
              f"iteration {rd.iterations}; printed {out.getvalue().splitlines()[1]!r}")
        _require(seen == [None, 0.05] and dbg.quit and rd.iterations == 2
                 and out.getvalue().splitlines()[1].startswith("min "),
                 "phase 22: the debugger's epsilon edit did not reach the next segment")
        m = MCMCColorer(g, params, backend="pallas", device=device)
        plain = m.run(seed=seed)
        _one_chain_syncs(m.ell, m.ell.n_pad, m.ell.n_nodes, params, m.block,
                         tm._sweep_pallas_fused, "MCMCColorer (K2 do-while, K3 tailcut)", 22,
                         ell=m.ell, node_mask=m.ell.node_mask)
        shapes.tag = "traced"
        err = io.StringIO()
        os.environ["MCMC_COLORER_TRACE"] = "1"
        try:
            with shapes, contextlib.redirect_stderr(err):  # the traced run alone
                traced = m.run(seed=seed)
        finally:
            del os.environ["MCMC_COLORER_TRACE"]
    lines = [ln for ln in err.getvalue().splitlines() if ln.startswith("Max Free Colors: ")]
    same = np.array_equal(traced.colors, plain.colors)
    valid = check_coloring(g, traced.colors) and traced.extra["final_conflicts"] == 0
    segs = traced.extra.get("free_color_trace_segments", [])
    print(f"phase 22 MCMCColorer under MCMC_COLORER_TRACE=1: {traced.iterations} iterations, "
          f"{len(lines)} TRACE lines ({lines[-1] if lines else ''}); chain "
          f"{traced.extra['chain_seconds']:.3f} s traced, {plain.extra['chain_seconds']:.3f} s "
          f"untraced; colours equal to the untraced run {same}; valid {valid}")
    _require(same and valid and len(lines) == len(segs) >= 1,
             "phase 22: the traced run differs, is invalid or printed no TRACE line")
    print(f"phase 22: {time.perf_counter() - t0:.3f} s before the kernel checks")
    return shapes.check(22, plain_runs=1)


def _chain_c_equals(make_one, summaries, best, seed, device, label):
    """Each chain c of an ensemble against a one-chain run fed chain c's
    source: iterations, conflicts and class-size std equal, and the best
    chain's colours."""
    import numpy as np

    from mcmc_colorer_tpu_torch.utils.rng import TorchUniformSource

    one = make_one()
    for c, s in enumerate(summaries):
        r = one.run(seed, source=TorchUniformSource(seed, 0, device, chain=c))
        same = ((r.iterations, r.extra["final_conflicts"]) == (s["iterations"], s["conflicts"])
                and float(r.histogram.std()) == s["class_std"])
        if c == best.extra["best_chain"]:
            same = same and np.array_equal(r.colors, best.colors)
        _require(same, f"{label}: chain {c} differs from its one-chain run")
    print(f"{label}: every chain equal to a one-chain run fed its source "
          f"(iterations {[s['iterations'] for s in summaries]})")


def phase_ensembles(device, g, g4, seed=5):
    """Slice 8, phase 23: ``EnsembleMCMCColorer(backend="pallas")`` with
    ``ENSEMBLE_CHAINS`` chains on phase 11's ER(100k, 0.01) host graph (nCol
    = max degree, seed 5) and with ``BUCKETED_CHAINS`` chains bucketed at
    config 4 (phase 10's BA(50k, 8), seed 41): the best colouring valid,
    K2 once a rectangle a batched body, each chain equal to a one-chain
    run fed its source, and every batched K2 and K3 launch held against
    its plain version and C single launches and timed
    (``_ChainShapes``).  Returns ``_ChainShapes.check``'s dict, with the
    flat run's digest (``_ensemble_digest``) under ``"reference"`` for
    phase 38."""
    import torch

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.models.base import check_coloring
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
    from mcmc_colorer_tpu_torch.ops import firstfit as k3
    from mcmc_colorer_tpu_torch.ops import resample as k2
    from mcmc_colorer_tpu_torch.parallel.chains import EnsembleMCMCColorer

    shapes = _ChainShapes()
    runs = ((g, ENSEMBLE_CHAINS, "flat", seed, f"ER({BENCH_N}, {BENCH_P})"),
            (g4, BUCKETED_CHAINS, "bucketed", 41, f"config 4 BA({CONFIG4_N}, {CONFIG4_M})"))
    for graph, chains, layout, s, name in runs:
        params = MCMCParams(n_colors=graph.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC,
                            tailcut=True)
        ens = EnsembleMCMCColorer(graph, params, chains, backend="pallas", layout=layout,
                                  device=device)
        ens.run(seed=s)  # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        k2.launches = k3.launches = 0
        shapes.tag = f"{name} {layout} ensemble"
        with shapes:
            best, summ = ens.run(seed=s)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        l2, l3 = k2.launches, k3.launches
        x = best.extra
        valid = check_coloring(graph, best.colors)
        pieces = len(ens.ell.slices) if layout == "bucketed" else 1
        print(f"phase 23 {name} {layout}, {chains} chains, n_colors={params.n_colors}, seed {s}"
              f": sweeps (batched bodies) {x['sweeps']}, chain {x['chain_seconds']:.3f} s "
              f"({x['chain_seconds'] / max(x['sweeps'], 1) * 1e3:.3f} ms a sweep of all "
              f"chains), run {best.duration_ms / 1e3:.3f} s; per chain iterations "
              f"{[c['iterations'] for c in summ]}, conflicts {[c['conflicts'] for c in summ]}; "
              f"best chain {x['best_chain']}; K2 launches {l2}, K3 launches {l3}; peak device "
              f"memory {peak} bytes above the {base} allocated before; valid {valid}")
        _require(valid and x["final_conflicts"] == 0, f"phase 23 {name}: invalid colouring")
        _require(l2 == x["sweeps"] * pieces > 0 and l3 > 0,
                 f"phase 23 {name}: {l2} K2 launches in {x['sweeps']} batched bodies")
        _chain_c_equals(lambda: MCMCColorer(graph, params, backend="pallas", layout=layout,
                                            device=device), summ, best, s, device,
                        f"phase 23 {name} {layout}")
        if layout == "flat":
            ref = _ensemble_digest((best, summ))
    torch.cuda.empty_cache()
    return {**shapes.check(23), "reference": ref}


def _ensemble_digest(result):
    """What two ensemble runs must share: the best colours, iterations,
    trace, the extra without its time, and the summaries."""
    best, summ = result
    return (best.colors.tolist(), best.iterations, best.conflict_trace.tolist(),
            {k: v for k, v in best.extra.items() if k != "chain_seconds"}, summ)


def phase_resident_ensemble(device, g, c_res, seed=5):
    """Slice 8, phase 24: ``ResidentMCMCColorer(100_000, 0.01, 0,
    n_chains=RESIDENT_CHAINS)`` (phase 4's hash graph and palette, seed 5):
    valid against phase 4's host graph; a run capped at 2 iterations
    (without the tailcut, which follows the checkpoint) writes a checkpoint
    and the resumed run equals the uninterrupted one; the ``matmul``
    ensemble over the host graph (K1 with a chain axis over A built from
    the ELL); the batched K1 launches of the uninterrupted run and of the
    ``matmul`` run, each under its own tag, held against the plain version
    and C single launches and timed (``_ChainShapes``); a do-while body of
    the resident chain at one chain reads the host once; then the resident
    TRACE once.  Returns (``_ChainShapes.check``'s dict, the TRACE run's K1
    launches)."""
    import numpy as np
    import torch

    from mcmc_colorer_tpu_torch.models.base import check_coloring
    from mcmc_colorer_tpu_torch.models.mcmc import _sweep_matmul
    from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer
    from mcmc_colorer_tpu_torch.ops import packed_nc as k1
    from mcmc_colorer_tpu_torch.parallel.chains import EnsembleMCMCColorer

    params = c_res.params
    shapes = _ChainShapes()

    def resident(**kw):
        return ResidentMCMCColorer(BENCH_N, BENCH_P, 0, params=kw.pop("params", params),
                                   n_chains=RESIDENT_CHAINS, device=device, **kw)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = 0
    shapes.tag = "resident ensemble"
    with tempfile.TemporaryDirectory() as td:
        with shapes:  # the uninterrupted run alone: the kernels line's row
            full, summ = resident().run_ensemble(seed=seed)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        l1 = k1.launches
        valid = check_coloring(g, full.colors)
        x = full.extra
        print(f"phase 24 resident ensemble ER({BENCH_N}, {BENCH_P}), {RESIDENT_CHAINS} chains, "
              f"n_colors={params.n_colors}, seed {seed}: sweeps (batched bodies) {x['sweeps']}, "
              f"per chain iterations {[c['iterations'] for c in summ]}, tailcut rounds "
              f"{x['tailcut_rounds']}, run {full.duration_ms / 1e3:.3f} s; K1 launches {l1}; "
              f"peak device memory {peak} bytes above the {base} allocated before; valid {valid}")
        _require(valid and x["final_conflicts"] == 0, "phase 24: invalid colouring")
        # a sweep one launch, the final count one where a chain stopped at
        # the cap, a tailcut round two (no NC is threaded between rounds)
        capped = any(c["iterations"] >= params.max_iterations for c in summ)
        _require(l1 == x["sweeps"] + capped + 2 * x["tailcut_rounds"],
                 f"phase 24: {l1} K1 launches for {x['sweeps']} sweeps and "
                 f"{x['tailcut_rounds']} tailcut rounds")
        ck = os.path.join(td, "resident.npz")
        pre, _ = resident(params=params.replace(max_iterations=2, tailcut=False)).run_ensemble(
            seed=seed, checkpoint_path=ck)
        res, summ_r = resident().run_ensemble(seed=seed, resume_from=ck)
        same = np.array_equal(res.colors, full.colors) and summ_r == summ
        print(f"phase 24 checkpoint at {pre.iterations} iterations, resumed: iterations "
              f"{[c['iterations'] for c in summ_r]}, equal to the uninterrupted run {same}")
        _require(same, "phase 24: the resumed ensemble differs from the uninterrupted one")
        shapes.tag = "matmul ensemble"
        ens = EnsembleMCMCColorer(g, params, RESIDENT_CHAINS, backend="matmul", device=device)
        k1.launches = 0
        with shapes:
            bm, sm = ens.run(seed=seed)
        lm = k1.launches
        valid = check_coloring(g, bm.colors) and bm.extra["final_conflicts"] == 0
        print(f"phase 24 matmul ensemble on the host graph, {RESIDENT_CHAINS} chains: A "
              f"{list(ens.colorer._adj.shape)}, sweeps {bm.extra['sweeps']}, chain "
              f"{bm.extra['chain_seconds']:.3f} s, iterations {[c['iterations'] for c in sm]}; "
              f"K1 launches {lm}; valid {valid}")
        _require(valid and lm == bm.extra["sweeps"] > 0,
                 f"phase 24: matmul ensemble invalid or {lm} K1 launches in "
                 f"{bm.extra['sweeps']} sweeps")
        del ens
    torch.cuda.empty_cache()
    rows = shapes.check(24)
    _one_chain_syncs(c_res.adj, c_res.n_pad, c_res.n, params, c_res.block, _sweep_matmul,
                     "the resident chain (K1 do-while)", 24, node_mask=c_res.node_mask)
    os.environ["MCMC_COLORER_TRACE"] = "1"
    k1.launches = 0
    try:
        tr = ResidentMCMCColorer(BENCH_N, BENCH_P, 0, params=params, device=device).run(
            seed=seed)
    finally:
        del os.environ["MCMC_COLORER_TRACE"]
    l1t = k1.launches
    segs = tr.extra.get("free_color_trace_segments", [])
    print(f"phase 24 resident TRACE: {len(segs)} segments {segs}, K1 launches {l1t}")
    _require(segs and tr.extra["final_conflicts"] == 0 and check_coloring(g, tr.colors),
             "phase 24: the resident TRACE run printed nothing or is invalid")
    torch.cuda.empty_cache()
    return rows, l1t


LOG_FIELDS = ("Nodes:", "Edges:", "Max deg:", "Edge probability", "Seed:", "Repetition:",
              "Execution time:", "Iteration performed:", "Max iteration reached:",
              "Color histogram:", "Number of colors:", "Used colors:", "Color ratio:",
              "Average number of nodes for each color:", "Variance:", "StD:",
              "BalancingIndex")


def _cli_run(args, n, tags, phase=15, launcher=()):
    """Run the port's CLI in a subprocess into a temporary directory, with
    its standard input from /dev/null; check its exit code, its logs' field
    names and its colour files.  ``launcher``: arguments of python before
    the module (``-m torch.distributed.run ...`` for torchrun).  Returns
    (the process, {colour file name: its text})."""
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, *launcher, "-m", "mcmc_colorer_tpu_torch.cli", *args,
             "--outDir", td],
            cwd=ROOT, capture_output=True, text=True, timeout=600, stdin=subprocess.DEVNULL,
        )
        wall = time.perf_counter() - t0
        _require(proc.returncode == 0,
                 f"CLI {' '.join(args)} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        files = sorted(os.listdir(td))
        logs = [f for f in files if f.endswith(".log")]
        _require({f.split("-")[-2] for f in logs} == set(tags), f"CLI logs {logs}")
        for f in logs:
            text = Path(td, f).read_text()
            missing = [k for k in LOG_FIELDS if k not in text]
            _require(not missing, f"{f} lacks {missing}")
            cf = Path(td, f[:-4] + "-colors.txt")
            _require(len(cf.read_text().splitlines()) == n, f"{cf.name}: not {n} lines")
        colors = {f: Path(td, f).read_text() for f in files if f.endswith("-colors.txt")}
    runs = [ln.split(" → ")[0] for ln in proc.stdout.splitlines() if " rep 0: " in ln]
    print(f"phase {phase} CLI {' '.join(args)}: exit 0 in {wall:.3f} s; {len(logs)} logs with "
          f"the reference's fields; {'; '.join(runs)}")
    _require(len(runs) == len(tags) and all("VALID" in x for x in runs), "CLI: a run not VALID")
    return proc, colors


def phase_cli():
    """The port's CLI as a user runs it: the four device colorers on a
    simulated ER(100k, 0.01), the resident path, --mcmccpu, at ER(20k,
    0.01) the frontier chain (--active, also --resident) and --backend
    packed, and at ER(20k, 0.001) the four device colorers with --layout
    bucketed, without and with --active."""
    _cli_run(["--simulate", "0.01", "-n", "100000", "--mcmcgpu", "--lubygpu", "--grdffgpu",
              "--vffgpu", "--tailcut", "--check", "--seed", "5"], 100_000,
             ("MCMC_GPU", "LUBY", "GFF", "VFF"))
    _cli_run(["--resident", "--simulate", "0.01", "-n", "100000", "--mcmcgpu", "--lubygpu",
              "--tailcut", "--check", "--seed", "5"], 100_000, ("MCMC_GPU", "LUBY"))
    _cli_run(["--simulate", "0.01", "-n", "2000", "--mcmccpu", "--tailcut", "--check",
              "--seed", "5"], 2_000, ("MCMC_CPU",))
    # slice 6: the frontier chain, with and without --resident, and the
    # packed backend over a host graph (Luby ignores --backend)
    _cli_run(["--simulate", "0.01", "-n", "20000", "--mcmcgpu", "--active", "--tailcut",
              "--check", "--seed", "5"], 20_000, ("MCMC_GPU",))
    _cli_run(["--resident", "--simulate", "0.01", "-n", "20000", "--mcmcgpu", "--active",
              "--tailcut", "--check", "--seed", "5"], 20_000, ("MCMC_GPU",))
    _cli_run(["--simulate", "0.01", "-n", "20000", "--mcmcgpu", "--lubygpu", "--backend",
              "packed", "--tailcut", "--check", "--seed", "5"], 20_000, ("MCMC_GPU", "LUBY"))
    # slice 7: the degree-bucketed layout for the four device colorers,
    # full and frontier
    for active in ([], ["--active"]):
        _cli_run(["--simulate", "0.001", "-n", "20000", "--layout", "bucketed", "--mcmcgpu",
                  "--grdffgpu", "--vffgpu", "--lubygpu", "--tailcut", "--check", "--seed", "5",
                  *active], 20_000, ("MCMC_GPU", "LUBY", "GFF", "VFF"))


def phase_cli_slice8():
    """Slice 8's CLI calls at ER(20k, 0.01), --tailcut --check --seed 5:
    --chains 4; --resident --chains 4 with --ckpt, then --resume (the same
    colours); --dbg with standard input from /dev/null (no break-in); -v 1
    (the free-colour TRACE lines on standard error)."""
    base = ["--simulate", "0.01", "-n", "20000", "--mcmcgpu", "--tailcut", "--check", "--seed",
            "5"]
    _cli_run(base + ["--chains", "4"], 20_000, ("MCMC_GPU",), phase=25)
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "resident.npz")
        _, first = _cli_run(base + ["--resident", "--chains", "4", "--ckpt", ck], 20_000,
                            ("MCMC_GPU",), phase=25)
        _require(os.path.exists(ck), "CLI --ckpt wrote no checkpoint")
        _, again = _cli_run(base + ["--resident", "--chains", "4", "--resume", ck], 20_000,
                            ("MCMC_GPU",), phase=25)
        _require(first == again, "CLI --resume ends in other colours than the run it resumes")
    _cli_run(base + ["--dbg"], 20_000, ("MCMC_GPU",), phase=25)
    proc, _ = _cli_run(base + ["-v", "1"], 20_000, ("MCMC_GPU",), phase=25)
    lines = [ln for ln in proc.stderr.splitlines() if "Max Free Colors: " in ln]
    print(f"phase 25 CLI -v 1: {len(lines)} free-colour TRACE lines ({lines[-1] if lines else ''})")
    _require(lines, "CLI -v 1 printed no free-colour TRACE line")


# slice 9: the sharded ensemble's chains on a 1x1 mesh (phase 26) and the
# frontier's ε there.  JAX's switch to frontier sweeps wants
# n_passive·(nCol−1)·ε <= 1; at ER(100k, 0.01), nCol 1150 and the
# reference's ε = 1e-8 that is 100k · 1149 · 1e-8 = 1.15, which holds the
# chain on full sweeps throughout, so the frontier run takes ε = 5e-9
# (0.57), and switches once at most n/8 rows conflict
SHARDED_CHAINS = 8
SHARDED_FRONTIER_EPS = 5e-9
SHARDED_CONFIG3_CHAINS = 2


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _sharded_digest(result):
    """What two sharded runs must share: the best colours, iterations,
    trace, summaries and the extra without its times."""
    best, summ = result
    times = ("chain_seconds", "tailcut_seconds", "setup_seconds")
    return (best.colors.tolist(), best.iterations, best.conflict_trace.tolist(),
            {k: v for k, v in best.extra.items() if k not in times}, summ)


def _sharded_run(c, g, label, phase, seed, shapes=(), tag=None, need=("K2",)):
    """One timed run of a sharded colorer with its counts set to 0 just
    before and read just after, inside the launch recorders ``shapes``
    (tagged ``tag``, by default ``label``); prints ms a sweep of all chains, sweeps, frontier
    sweeps, tailcut rounds, launches and peak device bytes, and requires a
    valid colouring and a launch of each kernel in ``need``.  Returns
    (result, K2 launches, K3 launches)."""
    import contextlib

    import torch

    from mcmc_colorer_tpu_torch.models.base import check_coloring
    from mcmc_colorer_tpu_torch.ops import firstfit as k3
    from mcmc_colorer_tpu_torch.ops import packed_nc as k1
    from mcmc_colorer_tpu_torch.ops import propose_nc as k4
    from mcmc_colorer_tpu_torch.ops import resample as k2

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for rec in shapes:
        rec.tag = tag or label
    k1.launches = k2.launches = k3.launches = k4.launches = 0
    with contextlib.ExitStack() as stack:
        for rec in shapes:
            stack.enter_context(rec)
        best, summ = c.run(seed=seed)
    torch.cuda.synchronize()
    l1, l2, l3 = k1.launches, k2.launches, k3.launches
    peak = torch.cuda.max_memory_allocated() - base
    x = best.extra
    valid = check_coloring(g, best.colors)
    print(f"phase {phase} {label}: {c.n_chains} chains on a {c.mesh.chains}x{c.mesh.shards} mesh, "
          f"n_colors={c.params.n_colors}, seed {seed}: sweeps {best.iterations}, chain "
          f"{x['chain_seconds']:.3f} s "
          f"({x['chain_seconds'] / max(best.iterations, 1) * 1e3:.3f} ms "
          f"a sweep of all chains), frontier sweeps of the best chain {x['frontier_sweeps']}, "
          f"tailcut rounds {x['tailcut_rounds']} ({x['tailcut_seconds']:.3f} s); per chain "
          f"conflicts {[r['conflicts'] for r in summ]}, accepted/attempted "
          f"{[(r['accepted_sweeps'], r['attempted_sweeps']) for r in summ]}; best chain "
          f"{x['best_chain']}, eps scale {x['final_eps_scale']}; K1 launches {l1}, K2 launches "
          f"{l2}, K3 launches {l3}; peak device memory {peak} bytes above the {base} allocated "
          f"before; valid {valid}, final conflicts {x['final_conflicts']}")
    _require(valid and x["final_conflicts"] == 0, f"phase {phase} {label}: invalid colouring")
    for kernel, n in (("K1", l1), ("K2", l2), ("K3", l3)):
        _require(kernel not in need or n > 0,
                 f"phase {phase} {label}: {kernel} launched no time")
    return (best, summ), l2, l3


def _chain_colors(c, seed):
    """Every chain's colours [n_chains, n] where the chain phase (no
    tailcut) of sharded colorer ``c`` ends, gathered over its mesh from
    each chain group's first shard."""
    import numpy as np

    st = c._run_sharded_segment(c.init_state(seed), c.params.max_iterations)
    parts = c.mesh.gather_objects(st.colors[:, :c.graph.n].cpu().numpy())
    return np.concatenate([x for r, x in enumerate(parts) if r % c.mesh.shards == 0])


def _init_nccl_world_of_one() -> None:
    """A one-rank NCCL process group, so the 1x1 mesh's collectives run
    through NCCL (its all-gathers and all-reduces of one rank)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)


def phase_sharded(device, g, seed=5):
    """Slice 9, phase 26: ``ShardedMCMCColorer`` (backend ``pallas``) with
    ``SHARDED_CHAINS`` chains on a 1x1 mesh under a one-rank NCCL group, on
    phase 11's ER(100k, 0.01) host graph at nCol = its max degree, tailcut
    on: full sweeps (K2 one launch for all chains a sweep), the frontier
    (``active_cap = n // 8``, K2 on the frontier's rows with ``self_ids``),
    Hastings (30 sweeps at most), pooled annealing, and full sweeps
    stopped after 2 (K3 in the rank-space tailcut, which each run enters
    when its best chain ends with conflicts).  Each valid; every launch recorded by shape; beside
    ``EnsembleMCMCColorer`` with as many chains on the same graph, timed
    in this call.  Returns (chain-axis rows, single-chain K2 rows, K3
    rows, K2 boundary fraction, qstar error, K3 error)."""
    import torch

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.parallel.chains import EnsembleMCMCColorer
    from mcmc_colorer_tpu_torch.parallel.mesh import make_mesh
    from mcmc_colorer_tpu_torch.parallel.sharded import AnnealConfig, ShardedMCMCColorer

    _init_nccl_world_of_one()
    mesh = make_mesh(1, 1)
    _require(mesh.distributed and mesh.device == device, f"phase 26: mesh {mesh}")
    cs, ls = _ChainShapes(), _LaunchShapes()
    base = dict(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    # at nCol 1150 the chains reach the tailcut's threshold within a few
    # sweeps and the best one often has no conflict left, so one run stops
    # after 2 sweeps and leaves its conflicts to the tailcut (K3)
    runs = (
        ("full", {}, {}),
        ("frontier", dict(epsilon=SHARDED_FRONTIER_EPS), dict(active_cap=g.n // 8)),
        ("hastings", dict(hastings=True, lambda_=25.0, max_iterations=30), {}),
        ("anneal", {}, dict(anneal=AnnealConfig(enabled=True))),
        ("tailcut after 2 sweeps", dict(max_iterations=2), {}),
    )
    l3_all, ms_full = 0, None
    for name, pkw, ckw in runs:
        c = ShardedMCMCColorer(g, MCMCParams(**base, **pkw), mesh, n_chains=SHARDED_CHAINS,
                               backend="pallas", **ckw)
        c.run(seed=seed)  # warm-up: each run's paths are timed warm
        (best, _), l2, l3 = _sharded_run(c, g, f"sharded 1x1 {name}", 26, seed, (cs, ls),
                                         tag=f"sharded 1x1 ER({BENCH_N}, {BENCH_P})")
        l3_all += l3
        if name == "full":
            ms_full = best.extra["chain_seconds"] / best.iterations * 1e3
        if name == "frontier":
            _require(best.extra["frontier_sweeps"] > 0, "phase 26: no frontier sweep ran")
    _require(l3_all > 0, "phase 26: the sharded tailcut launched K3 no time")
    ens = EnsembleMCMCColorer(g, MCMCParams(**base), SHARDED_CHAINS, backend="pallas",
                              device=device)
    ens.run(seed=seed)  # warm-up
    eb, _ = ens.run(seed=seed)
    ms_ens = eb.extra["chain_seconds"] / max(eb.extra["sweeps"], 1) * 1e3
    print(f"phase 26 the same {SHARDED_CHAINS} chains in EnsembleMCMCColorer: "
          f"{eb.extra['sweeps']} sweeps, {ms_ens:.3f} ms a sweep of all chains; the sharded "
          f"1x1 full run {ms_full:.3f} ms a sweep (its cnt recount and host read a sweep)")
    torch.cuda.empty_cache()
    chain_rows = cs.check(26)
    k2_rows, k3_rows, frac, qerr, err3 = ls.check(26, plain_runs=3)
    return chain_rows, k2_rows, k3_rows, frac, qerr, err3


def phase_sharded_config3(device, g3, seed=5):
    """Slice 9, phase 27: config 3 (ER(1M, 0.001)) on the 1x1 mesh at
    ``SHARDED_CONFIG3_CHAINS`` chains, numColRatio 1, full sweeps and the
    tailcut, timed warm: K2 in its L2 regime with a million rows on one
    rank.  Returns (chain-axis rows, single-chain K2 rows, K3 rows, K3
    error)."""
    import torch

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.ops import resample as k2
    from mcmc_colorer_tpu_torch.parallel.mesh import make_mesh
    from mcmc_colorer_tpu_torch.parallel.sharded import ShardedMCMCColorer

    _init_nccl_world_of_one()
    mesh = make_mesh(1, 1)
    cs, ls = _ChainShapes(), _LaunchShapes()
    p = MCMCParams(n_colors=g3.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    t0 = time.perf_counter()
    c = ShardedMCMCColorer(g3, p, mesh, n_chains=SHARDED_CONFIG3_CHAINS, backend="pallas")
    print(f"phase 27 config 3 sharded colorer: rows [{c.n_loc}, {c.d_pad}] on the rank, set-up "
          f"{time.perf_counter() - t0:.3f} s; K2 regime "
          f"{'staged' if k2.sweep_shape(g3.n, p.n_colors).staged else 'L2'}")
    c.run(seed=seed)  # warm-up: the run is timed warm, as phase 26's
    _sharded_run(c, g3, "sharded 1x1 config 3", 27, seed, (cs, ls))
    del c
    torch.cuda.empty_cache()
    chain_rows = cs.check(27)
    k2_rows, k3_rows, _, _, err3 = ls.check(27, plain_runs=1)
    torch.cuda.empty_cache()
    return chain_rows, k2_rows, k3_rows, err3


def phase_sharded_resume(device, g, ckpt, seed=5):
    """Slice 9, phase 28: on the 1x1 mesh with 2 chains (full sweeps,
    tailcut), runs in segments of 4 sweeps with a checkpoint each, and a
    fresh colorer resumed from a checkpoint written after 3 sweeps, each
    equal to the uninterrupted run (colours, iterations, trace, summaries).
    Leaves that checkpoint at ``ckpt`` and returns the uninterrupted run's
    digest and every chain's colours at the end of its chain phase, for
    phase 29's other geometries."""
    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.parallel.mesh import make_mesh
    from mcmc_colorer_tpu_torch.parallel.sharded import ShardedMCMCColorer

    mesh = make_mesh(1, 1)
    p = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    make = lambda: ShardedMCMCColorer(g, p, mesh, n_chains=2, backend="pallas")  # noqa: E731
    ref = _sharded_digest(make().run(seed=seed))
    seg = _sharded_digest(make().run(seed=seed, segment=4, checkpoint_path=ckpt))
    _require(seg == ref, "phase 28: the segmented run differs from the uninterrupted one")
    c1 = make()
    c1.save_checkpoint(c1._run_sharded_segment(c1.init_state(seed), 3), ckpt)
    res = _sharded_digest(make().run(seed=seed, resume_from=ckpt))
    _require(res == ref, "phase 28: the resumed run differs from the uninterrupted one")
    print(f"phase 28 sharded 1x1, 2 chains: segments of 4 with checkpoints, and a resume from "
          f"the checkpoint after 3 sweeps, both equal to the uninterrupted run ({ref[1]} sweeps, "
          f"conflicts {[r['conflicts'] for r in ref[4]]})")
    return ref, _chain_colors(make(), seed)


def _gloo_rank(rank, world, port, graph_npz, ckpt, out, seed):
    """Phase 29's spawned rank: joins a gloo group of ``world`` ranks on
    the one card and runs the 2-chain full-sweep ensemble at (2, 1), also
    resumed from phase 28's 1x1 checkpoint, and at (1, 2); rank 0 writes
    the digests and every chain's colours where its chain phase ends."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.graph.container import Graph
    from mcmc_colorer_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from mcmc_colorer_tpu_torch.parallel.sharded import ShardedMCMCColorer

    torch.cuda.set_device(0)
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                           backend="gloo")
    d = np.load(graph_npz)
    g = Graph(n=int(d["n"]), row_ptr=d["row_ptr"], cols=d["cols"], name="er100k")
    p = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    got = {}
    for geometry in ((2, 1), (1, 2)):
        mesh = make_mesh(*geometry)
        c = ShardedMCMCColorer(g, p, mesh, n_chains=2, backend="pallas")
        t0 = time.perf_counter()
        got[geometry] = (_sharded_digest(c.run(seed=seed)), time.perf_counter() - t0,
                         str(mesh.device), _chain_colors(c, seed))
        if geometry == (2, 1):
            got["resume"] = (_sharded_digest(c.run(seed=seed, resume_from=ckpt)), 0.0, "",
                             None)
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(got, f)
    dist.destroy_process_group()


def phase_two_ranks(device, g, ckpt, ref, ref_chains, seed=5, deadline_s=300.0):
    """Slice 9, phase 29: two gloo ranks spawned on the one card (NCCL
    refuses two ranks on one device), with CUDA tensors in their
    collectives: (2, 1) and (1, 2) at 2 chains on ER(100k, 0.01), full
    sweeps, each equal to the 1x1 run ``ref`` (a chain's full sweeps draw
    the same on every geometry) and chain by chain to its chain phase's
    colours ``ref_chains``, and (2, 1) resumed from phase 28's 1x1
    checkpoint equal to it too; then the CLI under torchrun with
    --mesh-shards 2.  The ranks are killed if they outlive
    ``deadline_s``."""
    import pickle

    import numpy as np
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as td:
        graph_npz, out = os.path.join(td, "g.npz"), os.path.join(td, "out.pkl")
        np.savez(graph_npz, n=g.n, row_ptr=g.row_ptr, cols=g.cols)
        t0 = time.perf_counter()
        ctx = mp.start_processes(_gloo_rank, args=(2, _free_port(), graph_npz, ckpt, out, seed),
                                 nprocs=2, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=1.0):
                _require(time.perf_counter() - t0 < deadline_s,
                         f"phase 29: the ranks still run after {deadline_s} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        with open(out, "rb") as f:
            got = pickle.load(f)
    wall = time.perf_counter() - t0
    for key, (dig, run_s, dev, chains) in got.items():
        _require(dig == ref, f"phase 29: {key} differs from the 1x1 run")
        _require(chains is None or np.array_equal(chains, ref_chains),
                 f"phase 29: {key}'s chains end in other colours than the 1x1 run's")
        print(f"phase 29 two gloo ranks on {dev or 'the card'}, {key}: equal to the 1x1 run "
              f"({dig[1]} sweeps)" + ("" if chains is None else
                                       f", each of its {len(chains)} chains' colours too")
              + f", run {run_s:.3f} s")
    print(f"phase 29 spawn of two ranks, three runs: {wall:.3f} s")
    _cli_run(["--simulate", "0.01", "-n", "20000", "--mcmcgpu", "--mesh-shards", "2",
              "--tailcut", "--check", "--seed", "5"], 20_000, ("MCMC_GPU",), phase=29,
             launcher=("-m", "torch.distributed.run", "--nproc-per-node", "2",
                       "--master-addr", "127.0.0.1", "--master-port", str(_free_port())))


def phase_sharded_offsets(device, g, seed=5):
    """Slice 9, phase 30: K2 and K3 at the sharded call sites on shard 1
    of a (1, 2) layout (its rows laid out on their own, own ids from
    ``row0 = n_loc``, the colour vector whole), as ``_full_branch`` (8
    chains, at the largest ε the path gives K2) and ``_tailcut_round``
    launch them, against their plain versions: K2 under the CDF-boundary
    rule with exact conflicts, K3 exactly.  These launches are checks, not
    the main path's."""
    import torch

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.models.mcmc import _p_eff
    from mcmc_colorer_tpu_torch.ops import firstfit as k3
    from mcmc_colorer_tpu_torch.ops import resample as k2
    from mcmc_colorer_tpu_torch.parallel.mesh import Mesh
    from mcmc_colorer_tpu_torch.parallel.sharded import ShardedMCMCColorer

    # the largest ε the sharded sweep hands K2: ``_eps_eff`` caps ε·scale
    # at 0.4 / (nCol − 1), so a kept colour's q, 1 − (nCol − 1)·ε, is at
    # least 0.6 (at (nCol − 1)·ε ≥ 1 it would be negative and the q row
    # no distribution)
    p = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC,
                   taboo_iterations=2, epsilon=0.4 / (g.max_degree - 1))
    c = ShardedMCMCColorer(g, p, Mesh(1, 2, 0, 1, device), n_chains=SHARDED_CHAINS,
                           backend="pallas")
    off, nr = c.offset, c.n_real
    flat = g.to_ell(pad_nodes_to=c.n_pad, pad_degree_to=c.d_pad, device=device).neighbors
    _require(off > 0 and torch.equal(c.neighbors, flat[off:off + c.n_loc]),
             "phase 30: shard 1's rows differ from the flat ELL's")
    del flat
    gen = torch.Generator(device=device).manual_seed(seed)
    colors = torch.randint(0, p.n_colors, (SHARDED_CHAINS, c.n_pad), generator=gen,
                           device=device, dtype=torch.int32)
    colors[:, g.n:] = p.n_colors
    taboo = torch.randint(0, 3, (SHARDED_CHAINS, nr), generator=gen, device=device,
                          dtype=torch.int32)
    unif = torch.rand((SHARDED_CHAINS, nr), generator=gen, device=device)
    p_eff = _p_eff(colors, p, g.n, torch.arange(c.n_pad, device=device) < g.n)
    args = (c.neighbors[:nr], colors[:, :g.n].contiguous(), colors[:, off:off + nr].contiguous(),
            taboo, off, unif, p_eff, torch.full((), p.epsilon, device=device), p)
    row = _k2_batched(k2, args, f"sharded shard 1 of (1, 2) rows [{nr}, {c.d_pad}] row0 {off}",
                      30)
    allow = torch.ones((p.n_colors,), dtype=torch.int32, device=device)
    e3 = _k3_check(k3, c.neighbors[:nr], colors[0].contiguous(), allow, p.n_colors, None,
                   f"sharded shard 1 of (1, 2) rows [{nr}, {c.d_pad}]", phase=30)
    del c, colors
    torch.cuda.empty_cache()
    return row["frac"], row["qerr"], e3


STRIP_SPEC = (BENCH_N, BENCH_P, 0)  # phase 4's hash graph
# phase 32's run left to the strip tailcut stops after this many sweeps:
# at nCol 1150 the chains reach the threshold at 4, the best one at 0
# conflicts; after 3 they hold 75-98 (on an H100), which the strip tailcut
# repairs in some tens of rounds
STRIP_TAILCUT_SWEEPS = 3


def phase_sharded_strips(device, g, seed=5):
    """Slice 10, phase 32: ``ShardedMCMCColorer(None, resident_spec=(100k,
    0.01, 0))`` on a 1x1 mesh under the one-rank NCCL group, phase 26's
    cell on the hash strips: 8 chains at nCol = the max degree, tailcut
    on; full sweeps (K1 for all chains twice a sweep: NC of the colouring
    and of the star), the frontier (ε 5e-9, cap n // 8; rows unpacked from
    the strip, K2 on them with ``self_ids``), Hastings (30 sweeps at
    most), and a run stopped after
    ``STRIP_TAILCUT_SWEEPS`` sweeps for the strip tailcut (K1 a round).
    The 1x1 strip is phase 4's cached A where the n_pad agree.  Each run
    warmed, then timed and valid against ``g``, phase 4's C++
    re-derivation of the same hash graph (phase 35's CLI ``--check`` runs
    the colorer's own ``host_graph()``).  Returns (K1 rows, K2 rows, the
    K2 boundary fraction and qstar error, the full run's digest, its first
    K1 inputs, ms a sweep, K4's launches in the timed runs and the shape
    of NC they read)."""
    import torch

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.ops import packed_nc as k1
    from mcmc_colorer_tpu_torch.ops import propose_nc as k4
    from mcmc_colorer_tpu_torch.ops.dense_adj import n_col_pad_of
    from mcmc_colorer_tpu_torch.ops.hashgen import _PACKED_CACHE
    from mcmc_colorer_tpu_torch.parallel.mesh import make_mesh
    from mcmc_colorer_tpu_torch.parallel.sharded import ShardedMCMCColorer

    _init_nccl_world_of_one()
    mesh = make_mesh(1, 1)
    k1s, ls = _K1Shapes("resident strips 1x1"), _LaunchShapes()
    base = dict(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    runs = (
        ("full", {}, {}, ("K1",)),
        ("frontier", dict(epsilon=SHARDED_FRONTIER_EPS), dict(active_cap=BENCH_N // 8),
         ("K1", "K2")),
        ("hastings", dict(hastings=True, lambda_=25.0, max_iterations=30), {}, ("K1",)),
        (f"tailcut after {STRIP_TAILCUT_SWEEPS} sweeps",
         dict(max_iterations=STRIP_TAILCUT_SWEEPS), {}, ("K1",)),
    )
    out, l1, l4 = {}, 0, 0
    for name, pkw, ckw, need in runs:
        t0 = time.perf_counter()
        c = ShardedMCMCColorer(None, MCMCParams(**base, **pkw), mesh, n_chains=SHARDED_CHAINS,
                               resident_spec=STRIP_SPEC, **ckw)
        strip = ("phase 4's cached A" if any(c.strip is a for a, _ in _PACKED_CACHE.values())
                 else "built for it")
        print(f"phase 32 resident strips {name}: strip {list(c.strip.shape)} ({strip}), n_pad "
              f"{c.n_pad}, set-up {time.perf_counter() - t0:.3f} s")
        c.run(seed=seed)  # warm-up: each run's paths are timed warm
        (best, summ), _, _ = _sharded_run(c, g, f"resident strips 1x1 {name}", 32, seed,
                                          (k1s, ls), tag=f"resident strips 1x1 {name}",
                                          need=need)
        l1 += k1.launches  # this run's, counted by the wrapper
        l4 += k4.launches
        x = best.extra
        out[name] = (best, summ)
        if name == "frontier":
            _require(x["frontier_sweeps"] > 0, "phase 32: no frontier sweep ran")
        if name.startswith("tailcut"):
            _require(x["tailcut_rounds"] > 0, "phase 32: the strip tailcut ran no round")
    nc4 = (c.n_chains, c.n_loc, n_col_pad_of(c.params.n_colors))
    del c
    torch.cuda.empty_cache()
    _require(k1s.launches() == l1, "phase 32: K1 launches by shape do not add up")
    _require(l4 > 0, "phase 32: the strips launched K4 no time")
    print(f"phase 32 K4 launches in the timed runs: {l4} at NC {list(nc4)}")
    full, _ = out["full"]
    ms_full = full.extra["chain_seconds"] / max(full.iterations, 1) * 1e3
    # the full run's first launch: the initial counts of all chains
    first = next(iter(k1s.seen.values()))[1]
    k1_rows = k1s.check(32)
    k2_rows, _, frac, qerr, _ = ls.check(32, plain_runs=3)
    torch.cuda.empty_cache()
    return (k1_rows, k2_rows, frac, qerr, _sharded_digest(out["full"]), first, ms_full,
            (l4, nc4))


def phase_sharded_matmul(device, g, seed=5):
    """Slice 10, phase 33: ``backend="matmul"`` on phase 11's ER(100k, 0.01)
    host graph at 8 chains on the 1x1 mesh: each rank's strip built from
    its ELL rows.  First the two backends on the same sources from the same
    initial state (counts equal: NC at the own colours against the
    gather): one full sweep's samples of the matmul run (the torch
    proposal on K1's NC) equal the ``pallas`` run's (K2) but at CDF-boundary
    rows (``_k2_compare``'s rule).  Then the matmul run with the tailcut
    (rank-space, K3, where the best chain ends with conflicts), warmed,
    timed and valid.  Returns (K1 rows, K3 rows, boundary fraction, K3
    error, ms a sweep)."""
    import torch

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.models.mcmc import _p_eff, _proposal_q
    from mcmc_colorer_tpu_torch.ops import packed_nc as k1
    from mcmc_colorer_tpu_torch.ops.neighbor import neighbor_colors, occupancy_matrix
    from mcmc_colorer_tpu_torch.parallel.mesh import make_mesh
    from mcmc_colorer_tpu_torch.parallel.sharded import ShardedMCMCColorer
    from mcmc_colorer_tpu_torch.utils.rng import TorchUniformSource

    _init_nccl_world_of_one()
    mesh = make_mesh(1, 1)
    p = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    t0 = time.perf_counter()
    cm = ShardedMCMCColorer(g, p, mesh, n_chains=SHARDED_CHAINS, backend="matmul")
    print(f"phase 33 matmul strip of the host graph {list(cm.strip.shape)}, set-up "
          f"{time.perf_counter() - t0:.3f} s")
    cp = ShardedMCMCColorer(g, p, mesh, n_chains=SHARDED_CHAINS, backend="pallas")
    sm, sp = cm.init_state(seed), cp.init_state(seed)
    _require(torch.equal(sm.colors, sp.colors) and torch.equal(sm.cnt, sp.cnt),
             "phase 33: the strip's initial counts differ from the gather's")
    eps_t = torch.full((), float(cm._eps_eff(sm)), dtype=torch.float32, device=device)
    ks = list(range(SHARDED_CHAINS))
    star_m = cm._full_branch(sm, ks, eps_t)[0]
    star_p = cp._full_branch(sp, ks, eps_t)[0]
    n, worst = g.n, 0
    p_eff = _p_eff(sm.colors, p, n, cm._full_real)
    for k in ks:
        src = TorchUniformSource(seed, 0, device, chain=k)
        src.next(n)  # the initial colouring's
        u = src.next(n)
        mism = (star_m[k, :n] != star_p[k, :n]).nonzero()[:, 0]
        worst = max(worst, mism.numel())
        _require(mism.numel() <= BOUNDARY_MAX_FRACTION * n,
                 f"phase 33: chain {k}'s first sweep differs at {mism.numel()} rows")
        if mism.numel():
            cur = sm.colors[k, mism]
            nbc = neighbor_colors(cm.neighbors[mism], sm.colors[k])
            occ = occupancy_matrix(nbc, p.n_colors)
            cdf = torch.cumsum(_proposal_q(cur, occ, p, p_eff[k], eps_t, p.n_colors), dim=1)
            kk, uu = star_m[k, mism].to(torch.int64), u[mism]
            near = (uu - cdf.gather(1, kk[:, None])[:, 0]).abs() <= BOUNDARY_RTOL * uu
            before = cdf.gather(1, (kk - 1).clamp(min=0)[:, None])[:, 0]
            near |= (kk >= 1) & ((uu - before).abs() <= BOUNDARY_RTOL * uu)
            _require(bool(near.all()), f"phase 33: chain {k} differs off a CDF boundary")
    print(f"phase 33 first sweep, matmul against pallas on the same sources: at most {worst} "
          f"CDF-boundary rows of {n} a chain")
    del cp, sm, sp, star_m, star_p
    k1s, ls = _K1Shapes("matmul strips 1x1"), _LaunchShapes()
    cm.run(seed=seed)  # warm-up
    (best, _), _, _ = _sharded_run(cm, g, "matmul strips 1x1", 33, seed, (k1s, ls),
                                   need=("K1",))
    _require(k1s.launches() == k1.launches, "phase 33: K1 launches by shape do not add up")
    ms = best.extra["chain_seconds"] / max(best.iterations, 1) * 1e3
    del cm
    torch.cuda.empty_cache()
    k1_rows = k1s.check(33)
    _, k3_rows, _, _, err3 = ls.check(33, plain_runs=3)
    torch.cuda.empty_cache()
    return k1_rows, k3_rows, worst / n, err3, ms


def _gloo_strip_rank(rank, world, port, out, seed):
    """Phase 34's spawned rank: joins a gloo group of ``world`` ranks on the
    one card, runs phase 32's full-sweep resident strips at (1, 2) and
    writes its digest, its strip's shape and its K1 launches."""
    import pickle

    import torch
    import torch.distributed as dist

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.ops import packed_nc as k1
    from mcmc_colorer_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from mcmc_colorer_tpu_torch.parallel.sharded import ShardedMCMCColorer

    torch.cuda.set_device(0)
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                           backend="gloo")
    mesh = make_mesh(1, 2)
    t0 = time.perf_counter()
    c = ShardedMCMCColorer(None, MCMCParams(n_colors=0, proposal=ProposalKind.BALANCE_DYNAMIC,
                                            tailcut=True),
                           mesh, n_chains=SHARDED_CHAINS, resident_spec=STRIP_SPEC)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    k1.launches = 0
    t0 = time.perf_counter()
    dig = _sharded_digest(c.run(seed=seed))
    torch.cuda.synchronize()
    got = {"digest": dig, "run_s": time.perf_counter() - t0, "setup_s": setup_s,
           "strip": tuple(c.strip.shape), "colors": (SHARDED_CHAINS, c.n_pad),
           "n_colors": c.params.n_colors, "k1": k1.launches, "device": str(mesh.device)}
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(got, f)
    dist.destroy_process_group()


def phase_strips_two_ranks(device, ref, first, seed=5, deadline_s=300.0):
    """Slice 10, phase 34: two gloo ranks spawned on the one card at (1, 2)
    on phase 32's hash graph, full sweeps at 8 chains with the palette
    from the banded degree pass over the mesh: each rank generates its own
    strip [n_loc, words]; the run equals phase 32's 1x1 full run ``ref``.
    Then K1 at the ranks' strip shape, on shard 1's strip built here
    (``Mesh(1, 2, 0, 1, device)``) and phase 32's first K1 colours
    (``first``, the colouring every rank starts from), held and timed.
    Returns the K1 row, its launches the ranks' sum."""
    import pickle

    import torch.multiprocessing as mp

    from mcmc_colorer_tpu_torch.ops import packed_nc as k1
    from mcmc_colorer_tpu_torch.ops.hashgen import er_packed_strips_on_device
    from mcmc_colorer_tpu_torch.parallel.mesh import Mesh

    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "out.pkl")
        t0 = time.perf_counter()
        ctx = mp.start_processes(_gloo_strip_rank, args=(2, _free_port(), out, seed), nprocs=2,
                                 join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=1.0):
                _require(time.perf_counter() - t0 < deadline_s,
                         f"phase 34: the ranks still run after {deadline_s} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        got = []
        for r in range(2):
            with open(f"{out}.{r}", "rb") as f:
                got.append(pickle.load(f))
    wall = time.perf_counter() - t0
    for r, x in enumerate(got):
        _require(x["digest"] == ref, f"phase 34: rank {r}'s run differs from the 1x1 run")
        print(f"phase 34 gloo rank {r} of (1, 2) on {x['device']}: strip {list(x['strip'])}, "
              f"n_colors {x['n_colors']} from the degree pass, set-up {x['setup_s']:.3f} s, "
              f"run {x['run_s']:.3f} s, K1 launches {x['k1']}: equal to the 1x1 run "
              f"({ref[1]} sweeps)")
    print(f"phase 34 spawn of two ranks: {wall:.3f} s")
    _require(got[0]["strip"] == got[1]["strip"], "phase 34: the ranks' strips differ in shape")
    n_pad = got[0]["colors"][1]
    strip, _ = er_packed_strips_on_device(*STRIP_SPEC, n_pad, Mesh(1, 2, 0, 1, device))
    _require(tuple(strip.shape) == got[1]["strip"]
             and tuple(first[1].shape) == got[1]["colors"],
             "phase 34: shapes differ from the ranks'")
    row = _k1_batched(k1, (strip, first[1], first[2]),
                      f"resident strips (1, 2) shard 1 {list(first[1].shape)} x "
                      f"{list(strip.shape)}", 34)
    del strip
    return {**row, "launches": got[0]["k1"] + got[1]["k1"]}


def phase_cli_slice10():
    """Slice 10's CLI calls at ER(20k, 0.01), --tailcut --check --seed 5:
    the resident strips under torchrun at --mesh-shards 2, and the host
    graph's strips (--backend packed) on a one-rank mesh."""
    base = ["--simulate", "0.01", "-n", "20000", "--mcmcgpu", "--tailcut", "--check", "--seed",
            "5"]
    _cli_run(base + ["--resident", "--mesh-shards", "2"], 20_000, ("MCMC_GPU",), phase=35,
             launcher=("-m", "torch.distributed.run", "--nproc-per-node", "2",
                       "--master-addr", "127.0.0.1", "--master-port", str(_free_port())))
    _cli_run(base + ["--backend", "packed", "--mesh-shards", "1"], 20_000, ("MCMC_GPU",),
             phase=35)


def phase_clis():
    """Phases 15, 25, 31 and 35, the CLI calls, as four concurrent lanes:
    each call is a subprocess of its own that pays ~8-10 s of imports and
    CUDA start-up, so the lanes overlap that; within a lane the calls run
    in order (phase 25's --resume follows its --ckpt).  Every call and
    check of each phase stays.  Returns each lane's seconds."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    lanes = (phase_cli, phase_cli_slice8, phase_cli_slice9, phase_cli_slice10)
    with ThreadPoolExecutor(max_workers=len(lanes)) as pool:
        futures = [pool.submit(timed, fn) for fn in lanes]
        return [f.result() for f in futures]


def phase_cli_slice9():
    """Slice 9's CLI calls at ER(20k, 0.01), --tailcut --check --seed 5:
    --active --chains 4 (the sharded colorer on a 1x1 mesh), also with
    --anneal."""
    base = ["--simulate", "0.01", "-n", "20000", "--mcmcgpu", "--tailcut", "--check", "--seed",
            "5", "--active", "--chains", "4"]
    _cli_run(base, 20_000, ("MCMC_GPU",), phase=31)
    _cli_run(base + ["--anneal"], 20_000, ("MCMC_GPU",), phase=31)


# slice 11: BASELINE.md configs 1, 2 and 5 through the port's script, the
# validation scripts, and the ensemble over a mesh
VALIDATE_MATRIX_CELLS = ((0.005, 1.0), (0.04, 2.0))  # (p, numColRatio) at n = 4000
VALIDATE_MATRIX_SEEDS = 3


def phase_baseline_configs(device, config3_max_degree, config3_peaks):
    """Slice 11, phase 36: ``scripts/run_baseline_configs``'s configs 1, 2
    and 5 at full size on the card (the sequential chain on ER(1000, 0.1);
    Luby on ER(100k, 0.01); 64 chains on ER(20k, 0.002), best-of-chains),
    each valid; config 5's batched K2 launches recorded by shape
    (``_ChainShapes``) and held against the plain version; configs 3 and 4
    are phases 9 and 10, whose constants must equal the script's.  Then
    the whole script with ``--small`` in a subprocess, every ``valid``
    true, and ``estimate_run_bytes`` of config 3 at ratio 1 beside phase
    9's measured chain peak.  Returns ``_ChainShapes.check``'s dict."""
    import torch

    from mcmc_colorer_tpu_torch.ops import firstfit as k3
    from mcmc_colorer_tpu_torch.ops import packed_nc as k1
    from mcmc_colorer_tpu_torch.ops import resample as k2
    from mcmc_colorer_tpu_torch.scripts import run_baseline_configs as rbc
    from mcmc_colorer_tpu_torch.utils.memtrack import estimate_run_bytes

    ours = (CONFIG3_N, CONFIG3_P, CONFIG3_SEED, CONFIG3_RATIOS, CONFIG3_RUN_SEED,
            CONFIG4_N, CONFIG4_M, CONFIG4_SEED, CONFIG4_RUN_SEED)
    theirs = (rbc.CONFIG3_N, rbc.CONFIG3_P, rbc.CONFIG3_SEED, rbc.CONFIG3_RATIOS,
              rbc.CONFIG3_RUN_SEED, rbc.CONFIG4_N, rbc.CONFIG4_M, rbc.CONFIG4_SEED,
              rbc.CONFIG4_RUN_SEED)
    _require(ours == theirs, f"phase 36: configs 3 and 4 differ from the script's: {ours} vs "
             f"{theirs}")
    t0 = time.perf_counter()
    e1 = rbc.config1(False, device)["config1_sequential"]
    _require(e1["valid"] is True, "phase 36: config 1 invalid")
    k1.launches = k2.launches = k3.launches = 0
    e2 = rbc.config2(False, device)["config2_luby"]
    print(f"phase 36 config 2 Luby ER({rbc.CONFIG2_N}, {rbc.CONFIG2_P}): two runs, K1 launches "
          f"{k1.launches}, K2 {k2.launches}, K3 {k3.launches} (the gather loop: torch ops)")
    _require(e2["valid"] is True, "phase 36: config 2 invalid")
    shapes = _ChainShapes()
    shapes.tag = f"config 5 ER({rbc.CONFIG5_N}, {rbc.CONFIG5_P})"
    k1.launches = k2.launches = k3.launches = 0
    with shapes:
        e5 = rbc.config5(False, device)["config5_ensemble"]
    l1, l2, l3 = k1.launches, k2.launches, k3.launches
    print(f"phase 36 config 5, {e5['chains']} chains: K2 launches {l2} (batched bodies), "
          f"K1 {l1}, K3 {l3}; run {e5['seconds']:.3f} s, {e5['seconds'] / max(l2, 1) * 1e3:.3f} "
          f"ms a batched body (run seconds over K2 launches); best chain {e5['best_chain']}, "
          f"best conflicts {e5['best_conflicts']}")
    _require(e5["valid"] is True and e5["best_conflicts"] == 0 and e5["chains"] == 64,
             "phase 36: config 5's best chain invalid")
    _require(l2 > 0 and shapes.launches("K2") == l2,
             f"phase 36: config 5 launched K2 {l2} times, {shapes.launches('K2')} batched")
    configs_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    rows = shapes.check(36)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "small.json")
        proc = subprocess.run(
            [sys.executable, "-m", "mcmc_colorer_tpu_torch.scripts.run_baseline_configs",
             "--small", "--out", out], cwd=ROOT, capture_output=True, text=True, timeout=600,
            stdin=subprocess.DEVNULL)
        _require(proc.returncode == 0,
                 f"phase 36: run_baseline_configs --small exited {proc.returncode}:\n"
                 f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
        with open(out) as f:
            small = json.load(f)
    valids = [e["valid"] for k, e in small.items() if k.startswith("config") and "valid" in e]
    valids += [e["valid"] for e in small["config3_ratio_sweep"]["sweep"].values()]
    _require(len(valids) == 8 and all(v is True for v in valids),
             f"phase 36: --small report has valids {valids}")
    print(f"phase 36 run_baseline_configs --small in a subprocess: exit 0, all {len(valids)} "
          f"valid, on {small['device']}, {time.perf_counter() - t1:.3f} s")
    ratio = CONFIG3_RATIOS[0]
    peak, block = config3_peaks[ratio]
    est = estimate_run_bytes(CONFIG3_N, config3_max_degree,
                             max(4, int(config3_max_degree / ratio)), block=block)
    print(f"phase 36 estimate_run_bytes config 3 ratio {ratio} (block {block}): "
          + ", ".join(f"{k} {v}" for k, v in est.items())
          + f"; phase 9's measured chain peak {peak} bytes above the graph's ELL")
    print(f"phase 36 configs 1, 2, 5 at full size {configs_s:.3f} s")
    return rows


def phase_validation(device):
    """Slice 11, phase 37: ``scripts/validate_stats`` in full (ER(1000,
    0.1), 20 seeds, the sequential chain against K2's chain), its four
    checks required; two ``validate_matrix`` cells through its functions,
    each with ``VALIDATE_MATRIX_SEEDS`` seeds, their checks and the
    variant separation required, printed beside the JAX record
    (``docs/validate_matrix.json``).  The K2 and K3 launches of these runs
    are recorded by shape (``_LaunchShapes``) and held against the plain
    versions.  Returns ``_LaunchShapes.check``'s tuple."""
    from mcmc_colorer_tpu_torch.graph.generate import erdos_renyi
    from mcmc_colorer_tpu_torch.ops import firstfit as k3
    from mcmc_colorer_tpu_torch.ops import resample as k2
    from mcmc_colorer_tpu_torch.scripts import validate_matrix as vm
    from mcmc_colorer_tpu_torch.scripts import validate_stats as vs

    ls = _LaunchShapes()
    ls.tag = "validate_stats ER(1000, 0.1)"
    t0 = time.perf_counter()
    k2.launches = k3.launches = 0
    with ls:
        rep = vs.validate(device=device)
    l2, l3 = k2.launches, k3.launches
    s, d = rep["sequential"], rep["parallel"]
    print(f"phase 37 validate_stats {rep['config']}: checks {rep['checks']}; used colours "
          f"{s['used_colors']['mean']:.2f}/{d['used_colors']['mean']:.2f}, iterations "
          f"{s['iterations']['mean']:.2f}/{d['iterations']['mean']:.2f}, balance index "
          f"{s['balance_index']['mean']:.4f}±{s['balance_index']['std']:.4f}/"
          f"{d['balance_index']['mean']:.4f}±{d['balance_index']['std']:.4f}, class std "
          f"{s['class_std']['mean']:.3f}/{d['class_std']['mean']:.3f} (sequential/device); "
          f"K2 launches {l2}, K3 {l3}; {time.perf_counter() - t0:.3f} s")
    _require(all(rep["checks"].values()), f"phase 37: validate_stats checks {rep['checks']}")
    _require(l2 > 0, "phase 37: validate_stats launched K2 no time")
    with open(ROOT / "docs" / "validate_matrix.json") as f:
        record = {(c["p"], c["ratio"]): c for c in json.load(f)["cells"]}
    for p_edge, ratio in VALIDATE_MATRIX_CELLS:
        t1 = time.perf_counter()
        g = erdos_renyi(4000, p_edge, seed=777)
        ls.tag = f"validate_matrix p={p_edge} ratio={ratio}"
        k2.launches = k3.launches = 0
        with ls:
            c = vm.matrix_cell(g, p_edge, ratio, VALIDATE_MATRIX_SEEDS, device)
        l2, l3 = k2.launches, k3.launches
        jc = record[(p_edge, ratio)]

        def line(x):
            return (f"nCol {x['n_colors']}, BI seq/dev/dyn "
                    f"{x['sequential_standard']['balance_index']:.3f}/"
                    f"{x['device_standard']['balance_index']:.3f}/"
                    f"{x['device_balance_dynamic']['balance_index']:.3f}, converged seq/dev "
                    f"{x['sequential_standard']['converged']}/"
                    f"{x['device_standard']['converged']}, class std standard/decrease_exp "
                    f"{x['variant_effect']['standard']['class_std_mean']:.2f}/"
                    f"{x['variant_effect']['decrease_exp']['class_std_mean']:.2f}, separates "
                    f"{x['variants_separate']}, checks {all(x['checks'].values())}")

        print(f"phase 37 validate_matrix cell p={p_edge} ratio={ratio}, "
              f"{VALIDATE_MATRIX_SEEDS} seeds: {line(c)}; K2 launches {l2}, K3 {l3}; "
              f"{time.perf_counter() - t1:.3f} s | JAX record (TPU v5e, 10 seeds): {line(jc)}")
        _require(all(c["checks"].values()) and c["variant_effect"]["separates"],
                 f"phase 37: matrix cell p={p_edge} ratio={ratio}: checks {c['checks']}, "
                 f"separates {c['variant_effect']['separates']}")
        _require(l2 > 0 and l3 > 0, f"phase 37: cell p={p_edge} launched K2 {l2}, K3 {l3}")
    print(f"phase 37 validate_stats and two matrix cells {time.perf_counter() - t0:.3f} s")
    return ls.check(37, plain_runs=3)


def _gloo_ensemble_rank(rank, world, port, graph_npz, out_dir, seed):
    """Phase 38's spawned rank: joins a gloo group of ``world`` ranks on
    the one card and runs phase 23's 8-chain ensemble over a (2, 1) mesh,
    its 4 chains; writes its digest and run seconds."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.graph.container import Graph
    from mcmc_colorer_tpu_torch.parallel.chains import EnsembleMCMCColorer
    from mcmc_colorer_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    torch.cuda.set_device(0)
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                           backend="gloo")
    d = np.load(graph_npz)
    g = Graph(n=int(d["n"]), row_ptr=d["row_ptr"], cols=d["cols"], name="er100k")
    p = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    ens = EnsembleMCMCColorer(g, p, ENSEMBLE_CHAINS, mesh=make_mesh(2, 1), backend="pallas")
    t0 = time.perf_counter()
    result = ens.run(seed=seed)
    run_s = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump((_ensemble_digest(result), run_s, ens.first_chain, ens.local_chains,
                     str(ens.device)), f)
    dist.destroy_process_group()


def phase_mesh_ensemble(device, g, ref, seed=5, deadline_s=300.0):
    """Slice 11, phase 38: ``EnsembleMCMCColorer(g, params, 8, mesh=...)``
    over two gloo ranks spawned on the one card at (2, 1), each running 4
    of phase 23's 8 chains on phase 11's ER(100k, 0.01) host graph at nCol
    = its max degree (1150): each rank's (best, summaries) must equal
    phase 23's one-rank ensemble ``ref`` chain by chain, exactly, so both
    ranks return the same best.  The ranks are killed if they outlive
    ``deadline_s``.  Returns the spawn's seconds."""
    import pickle

    import numpy as np
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as td:
        graph_npz = os.path.join(td, "g.npz")
        np.savez(graph_npz, n=g.n, row_ptr=g.row_ptr, cols=g.cols)
        t0 = time.perf_counter()
        ctx = mp.start_processes(_gloo_ensemble_rank,
                                 args=(2, _free_port(), graph_npz, td, seed),
                                 nprocs=2, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=1.0):
                _require(time.perf_counter() - t0 < deadline_s,
                         f"phase 38: the ranks still run after {deadline_s} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        got = []
        for r in range(2):
            with open(os.path.join(td, f"{r}.pkl"), "rb") as f:
                got.append(pickle.load(f))
    wall = time.perf_counter() - t0
    for r, (dig, run_s, first, k, dev) in enumerate(got):
        _require(dig == ref, f"phase 38: rank {r}'s ensemble differs from phase 23's one rank")
        print(f"phase 38 rank {r} of a (2, 1) mesh on {dev}, chains {first}..{first + k - 1}: "
              f"best chain {dig[3]['best_chain']}, summaries of all {len(dig[4])} chains and "
              f"the best colours equal to phase 23's one-rank ensemble; run {run_s:.3f} s")
    print(f"phase 38 spawn of two gloo ranks: {wall:.3f} s")
    return wall


# slice 12: the offline analysis of logs the port's CLI has just written on
# the card: the host chain, the device chain and Luby at two sizes, and the
# device chain at three palettes (the var-col surface's cells)
ANALYSIS_P = 0.005
ANALYSIS_SIZES = (2_000, 4_000)
ANALYSIS_RATIO_N, ANALYSIS_RATIOS = 20_000, (1.0, 2.0, 4.0)


def _jax_modules() -> list[str]:
    return sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                  or m == "mcmc_colorer_tpu" or m.startswith("mcmc_colorer_tpu."))


def phase_analysis(smi):
    """Slice 12, phase 39: the port's CLI, in this process, writes a batch
    of logs (``--simulate 0.005 --mcmccpu --mcmcgpu --lubygpu --tailcut
    --check --repet 2 --seed 5`` at n = 2,000 and 4,000; ``--mcmcgpu`` at
    ER(20k, 0.005) with ``-r`` 1, 2 and 4), which
    ``mcmc_colorer_tpu_torch.analysis`` then reads with neither jax nor the
    JAX package loaded: the tags and records a size, each histogram
    against its colour file and the log's BalancingIndex, both speedup
    kinds at both sizes, the var-col surface's three cells, the runs at
    their cap, the JSON round trip, and the plots (drawn, or skipped where
    matplotlib is missing: the reference's contract).  The speedups are
    printed beside the card's name and power limit ``smi``.  The batch's K2
    and K3 launches are recorded by shape (``_LaunchShapes``) and held
    against the plain versions.  Returns ``_LaunchShapes.check``'s tuple."""
    import numpy as np

    from mcmc_colorer_tpu_torch import analysis
    from mcmc_colorer_tpu_torch.analysis import log_parser
    from mcmc_colorer_tpu_torch.cli import main as cli_main
    from mcmc_colorer_tpu_torch.ops import firstfit as k3
    from mcmc_colorer_tpu_torch.ops import resample as k2

    ls = _LaunchShapes()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        base = ["--simulate", str(ANALYSIS_P), "--tailcut", "--check", "--seed", "5", "--quiet",
                "--outDir", td]
        calls = [(f"n={n}", ["-n", str(n), "--mcmccpu", "--mcmcgpu", "--lubygpu", "--repet", "2"])
                 for n in ANALYSIS_SIZES]
        calls += [(f"n={ANALYSIS_RATIO_N} r={r}",
                   ["-n", str(ANALYSIS_RATIO_N), "-r", str(r), "--mcmcgpu"])
                  for r in ANALYSIS_RATIOS]
        k2.launches = k3.launches = 0
        with ls:
            for tag, args in calls:
                ls.tag = f"analysis batch {tag}"
                rc = cli_main(base + args)
                _require(rc == 0, f"phase 39: the CLI {' '.join(args)} returned {rc}")
        l2, l3 = k2.launches, k3.launches
        write_s = time.perf_counter() - t0
        _require(l2 > 0 and l3 > 0, f"phase 39: the batch launched K2 {l2}, K3 {l3} times")
        t1 = time.perf_counter()
        res = analysis.parse_results_dir(td)
        _require(not _jax_modules(), f"phase 39: the analysis loaded {_jax_modules()}")
        _require(set(res) == {"MCMC_CPU", "MCMC_GPU", "LUBY"}, f"phase 39: tags {sorted(res)}")
        want = {(t, n): 2 for t in res for n in ANALYSIS_SIZES}
        want[("MCMC_GPU", ANALYSIS_RATIO_N)] = len(ANALYSIS_RATIOS)
        got = {}
        for tag, runs in res.items():
            for r in runs:
                got[(tag, r["nodes"])] = got.get((tag, r["nodes"]), 0) + 1
                hist = r["histogram"]
                colors = np.loadtxt(r["path"][:-4] + "-colors.txt", dtype=np.int64)[:, 1]
                _require(sum(hist) == r["nodes"] == len(colors)
                         and np.bincount(colors, minlength=len(hist)).tolist() == hist,
                         f"phase 39: {r['path']}: histogram against its colour file")
                bi = analysis.balance_index(hist, r["nodes"], r["prob"], r["n_colors"])
                _require(abs(bi - r["balancing_index"]) <= 1e-9,
                         f"phase 39: {r['path']}: balance index {bi} against the log's "
                         f"{r['balancing_index']}")
        _require(got == want, f"phase 39: records by (tag, n) {got}, expected {want}")
        sp, psp = analysis.speedups(res), analysis.per_iteration_speedups(res)
        for kind, table in (("speedups", sp), ("per-iteration speedups", psp)):
            for pair in ("MCMC_CPU/MCMC_GPU", "LUBY/MCMC_GPU"):
                row = table.get(pair, {})
                _require(sorted(row) == list(ANALYSIS_SIZES)
                         and all(np.isfinite(v) and v > 0 for v in row.values()),
                         f"phase 39: {kind} {pair} {row}")
                print(f"phase 39 {kind} {pair}: " + ", ".join(
                    f"n={n} {row[n]!r}" for n in ANALYSIS_SIZES) + f" ({smi})")
        surface = log_parser.var_col_surface(res)
        _require(sorted(surface) == [(r, ANALYSIS_P) for r in ANALYSIS_RATIOS],
                 f"phase 39: var-col surface cells {sorted(surface)}")
        print("phase 39 var-col surface (MCMC_GPU, mean balance index by ratio, p): "
              + ", ".join(f"{k} {v!r}" for k, v in sorted(surface.items())))
        print("phase 39 runs at their iteration cap: " + ", ".join(
            f"{t} {analysis.count_non_convergent(runs)} of {len(runs)}"
            for t, runs in sorted(res.items())))
        out = os.path.join(td, "results.json")
        saved = log_parser.save_results_json(td, out)
        with open(out) as f:
            _require(json.load(f) == saved == res, "phase 39: the JSON round trip differs")
        drawn = {
            "speedup": log_parser.plot_speedup(res, os.path.join(td, "speedup.png")),
            "speedup per iteration": log_parser.plot_speedup(
                res, os.path.join(td, "speedup_iter.png"), per_iteration=True),
            "var-col 3d": log_parser.plot_var_col_3d(res, os.path.join(td, "varcol.png")),
            "balance index": log_parser.plot_balance_index(
                res, os.path.join(td, "bi.png"), prob=ANALYSIS_P),
        }
        print("phase 39 plots: " + ", ".join(
            f"{k} {'drawn' if v else 'skipped (no matplotlib)'}" for k, v in drawn.items()))
        _require(not _jax_modules(), f"phase 39: the plots loaded {_jax_modules()}")
        analyse_s = time.perf_counter() - t1
    print(f"phase 39 the batch ({len(calls)} CLI calls, K2 launches {l2}, K3 {l3}) "
          f"{write_s:.3f} s; its analysis {analyse_s:.3f} s; no jax module loaded")
    return ls.check(39, plain_runs=3)


# phase 40: the resident chain's palettes (max degree / 1, 2, 4) and the
# sharded strips' chains (phase 32)
K4_RATIOS = (1, 2, 4)
K4_STRIP_CHAINS = 8


def _k4_bytes(nc, p_eff, n_colors) -> int:
    """K4's bytes, each once: NC's palette columns (rounded up to the
    kernel's 16-byte copies; the padding past them is not read), the [C,
    rows] vectors in (cur, taboo, unif) and out (star, new_taboo, qstar),
    real, p_eff and conf2."""
    c, rows, _ = nc.shape
    return (4 * c * rows * _round_up(n_colors, 4) + 6 * 4 * c * rows + rows
            + (0 if p_eff is None else _nbytes(p_eff)) + 8 * c)


def _k4_shape(k4, label, nc, cur, taboo, unif, real, p_eff, params, block):
    """K4 against its plain version on one shape: conf2 exact, samples
    equal but at CDF-boundary rows (at most BOUNDARY_MAX_FRACTION of the
    real rows), new_taboo equal and Σ log qstar within 1e-4 (relative)
    where they agree; then both timed.  A row of the kernels line's K4
    ``shapes``, its ``launches`` those of the main paths, set by
    ``_k4_summary``."""
    import torch

    from mcmc_colorer_tpu_torch.models.mcmc import _proposal_q

    eps = torch.full((), params.epsilon, dtype=torch.float32, device=nc.device)
    n_colors = params.n_colors
    star, new_taboo, qstar, conf2 = k4.propose_nc_cuda(nc, cur, taboo, unif, real, p_eff, eps,
                                                       params)
    torch.cuda.synchronize()
    want = k4.propose_nc_plain(nc, cur, taboo, unif, real, p_eff, eps, params, block)
    _require(torch.equal(conf2, want[3]), f"phase 40 K4 {label}: conf2 {conf2.tolist()} vs "
             f"plain {want[3].tolist()}")
    logq = torch.log(qstar.clamp(min=1e-30)).sum(1)
    c, rows, n_col_pad = nc.shape
    n_real = int(real.sum())
    worst, lrel = 0, 0.0
    for k in range(c):
        mism = (star[k] != want[0][k]).nonzero()[:, 0]
        worst = max(worst, mism.numel())
        _require(mism.numel() <= BOUNDARY_MAX_FRACTION * n_real,
                 f"phase 40 K4 {label}: samples differ at {mism.numel()} of {n_real} rows")
        # Σ log qstar over the rows where the samples agree: a boundary
        # row's two colours have different q
        got_l, want_l = logq[k], want[2][k]
        if mism.numel():
            p_pad = None
            if p_eff is not None:
                p_pad = torch.zeros(n_col_pad, dtype=torch.float32, device=nc.device)
                p_pad[:n_colors] = p_eff[k]
            q = _proposal_q(cur[k][mism], nc[k][mism] > 0, params, p_pad, eps, n_colors)
            cdf = torch.cumsum(q, dim=1)
            j = want[0][k][mism].to(torch.int64)
            u = unif[k][mism]
            near = (u - cdf.gather(1, j[:, None])[:, 0]).abs() <= BOUNDARY_RTOL * u
            before = cdf.gather(1, (j - 1).clamp(min=0)[:, None])[:, 0]
            near |= (j >= 1) & ((u - before).abs() <= BOUNDARY_RTOL * u)
            _require(bool(near.all()), f"phase 40 K4 {label}: differs off a CDF boundary")
            got_l = got_l - torch.log(qstar[k][mism].clamp(min=1e-30)).sum()
            want_l = want_l - torch.log(q.gather(1, j[:, None])[:, 0].clamp(min=1e-30)).sum()
        lrel = max(lrel, float((got_l - want_l).abs() / want_l.abs().clamp(min=1e-30)))
        _require(lrel <= 1e-4, f"phase 40 K4 {label}: log qstar off by {lrel:.3g} (relative)")
        keep = star[k] == want[0][k]
        _require(torch.equal(new_taboo[k][keep], want[1][k][keep]),
                 f"phase 40 K4 {label}: new_taboo differs")
    k_ms = _median_ms(lambda: k4.propose_nc_cuda(nc, cur, taboo, unif, real, p_eff, eps,
                                                 params), queued=True)
    p_ms = _median_ms(lambda: k4.propose_nc_plain(nc, cur, taboo, unif, real, p_eff, eps,
                                                  params, block), runs=3)
    n_bytes = _k4_bytes(nc, p_eff, n_colors)
    b_ms, _ = _bound(n_bytes, 0, FP32_OPS_PER_S)
    print(f"phase 40 K4 {label} [{c}, {rows}, {n_col_pad}] n_colors={n_colors}: conf2 "
          f"{conf2.tolist()} exact; at most {worst} boundary rows a chain of {n_real}; log "
          f"qstar max rel err {lrel:.3g}; kernel {k_ms:.4f} ms (the launch queued), plain "
          f"{p_ms:.3f} ms (median of {TIMED_RUNS}, plain of 3, CUDA events); bound "
          f"{b_ms:.4f} ms ({n_bytes} bytes), {100 * b_ms / k_ms:.1f} % of it")
    return {"shape": label, "chains": c, "rows": rows, "n_col_pad": n_col_pad,
            "n_colors": n_colors, "taboo": params.taboo_iterations, "launches": 0,
            "boundary_rows": worst, "logq_rel_err": lrel, "ms": k_ms, "plain_ms": p_ms,
            "bytes": n_bytes, "ops": 0}


def phase_k4(device, c_res, seed=5):
    """K4 against its plain version at the resident chain's palettes and the
    strips' shape, on NC from K1 over ``c_res``'s graph (phase 4's
    ER(100k, 0.01)): colours drawn uniformly over the palette (phantom
    rows at nCol), the configuration's taboo 0, and once taboo counters
    up to 4.  Returns its rows."""
    import torch

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind, default_n_colors
    from mcmc_colorer_tpu_torch.models.mcmc import _p_eff, choose_block_size
    from mcmc_colorer_tpu_torch.ops import propose_nc as k4
    from mcmc_colorer_tpu_torch.ops.dense_adj import neighbor_color_counts

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n, n_pad = c_res.n, c_res.n_pad
    real = torch.arange(n_pad, device=device) < n
    rows = []

    def shape(label, n_colors, chains, taboo_max=0):
        params = MCMCParams(n_colors=n_colors, proposal=ProposalKind.BALANCE_DYNAMIC,
                            taboo_iterations=taboo_max)
        colors = torch.stack([_real_colors(n, n_pad, n_colors, gen, device)
                              for _ in range(chains)])
        nc = neighbor_color_counts(c_res.adj, colors, n_colors, real)
        p_eff = _p_eff(colors, params, n, real)
        taboo = torch.randint(0, taboo_max + 1, colors.shape, generator=gen, device=device,
                              dtype=torch.int32)
        unif = torch.rand(colors.shape, generator=gen, device=device)
        rows.append(_k4_shape(k4, label, nc, colors, taboo, unif, real, p_eff, params,
                              choose_block_size(n_pad, n_colors)))
        del nc
        torch.cuda.empty_cache()

    for ratio in K4_RATIOS:
        n_colors = default_n_colors(c_res.max_degree, ratio)
        shape(f"resident nCol {n_colors}", n_colors, 1)
    shape(f"resident nCol {c_res.max_degree}, taboo 4", c_res.max_degree, 1, taboo_max=4)
    shape(f"strips, {K4_STRIP_CHAINS} chains", c_res.max_degree, K4_STRIP_CHAINS)
    return rows


def _k4_summary(rows, chain, strips) -> dict:
    """The kernels line's K4 entry: phase 40's shapes, each timed beside its
    bound, with the launches of the main paths at that shape, ``chain``
    (phase 4's n_pad, palette and K4 launches: one chain, taboo off) and
    ``strips`` (phase 32's K4 launches and their NC shape); times are
    weighted by those launches."""
    (n_pad, n_colors, chain_n), (strips_n, strips_nc) = chain, strips
    for x in rows:
        x["bound_ms"], x["bound_by"] = _bound(x["bytes"], x["ops"], FP32_OPS_PER_S)
        x["bound_share"] = x["bound_ms"] / x["ms"]
        if (x["chains"], x["rows"], x["n_colors"], x["taboo"]) == (1, n_pad, n_colors, 0):
            x["launches"] += chain_n
        if (x["chains"], x["rows"], x["n_col_pad"]) == strips_nc:
            x["launches"] += strips_n
    n = sum(x["launches"] for x in rows)
    _require(n == chain_n + strips_n,
             f"K4's main-path launches ({chain_n} + {strips_n}) match no phase 40 shape")

    def weighted(key):
        return sum(x[key] * x["launches"] for x in rows) / n

    return {
        "name": "propose_nc",
        "route": "cuda",
        "source": "mcmc_colorer_tpu_torch/csrc/propose_nc.cu",
        "replaces": None,  # the JAX package proposes in jnp (models/mcmc.py:103, :178)
        "launches": n,
        "boundary_rows": max(x["boundary_rows"] for x in rows),
        "logq_rel_err": max(x["logq_rel_err"] for x in rows),
        "ms": weighted("ms"),
        "plain_ms": weighted("plain_ms"),
        "bound_ms": weighted("bound_ms"),
        "bound_by": "bytes",
        "bound_share": weighted("bound_ms") / weighted("ms"),
        "library_ms": None,
        "shapes": rows,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "mcmc_colorer_tpu_torch" / "csrc" / "packed_nc.cu").is_file():
        raise SystemExit(f"chip_smoke.py: {ROOT} is not a checkout of the repository")
    from mcmc_colorer_tpu_torch.ops.dense_adj import n_col_pad_of

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"phase 0 card: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    built = build_kernels()
    build_s = time.perf_counter() - t0
    b1, b2, b3, b4, b5, b6 = (built[k][1] for k in ("K1", "K2", "K3", "K4", "K5", "K6"))
    print(f"phase 1 build K1: {b1.seconds:.3f} s ({b1.path.name}); ptxas: {_ptxas(b1)}")
    print(f"phase 1 build K4: {b4.seconds:.3f} s ({b4.path.name}); ptxas: {_ptxas(b4)}")
    print(f"phase 1 build K5: {b5.seconds:.3f} s ({b5.path.name}); ptxas: {_ptxas(b5)}")
    print(f"phase 1 build K6: {b6.seconds:.3f} s ({b6.path.name}); ptxas: {_ptxas(b6)}")

    err, k_ms, p_ms, k1_bytes, k1_bits = phase_k1(
        device, K1_SHAPES, bench_n_pad=_round_up(BENCH_N, 2048))
    torch.cuda.empty_cache()
    phase_hash(device)
    k6_entry = phase_k6(device)
    torch.cuda.empty_cache()
    r_main, c, launches, g_bench, k4_chain, k6_entry["launches"] = phase_main(device)
    k4_chain = (c.n_pad, c.params.n_colors, k4_chain)
    k4_rows = phase_k4(device, c)
    torch.cuda.empty_cache()
    chain_ncp = n_col_pad_of(c.params.n_colors)
    _require(chain_ncp == n_col_pad_of(K1_BENCH_COLORS),
             f"the chain ran K1 at {chain_ncp} padded colours, timed at {K1_BENCH_COLORS}")
    phase_tight(device)

    for label, b in (("K2", b2), ("K3", b3)):
        print(f"phase 6 build {label}: {b.seconds:.3f} s ({b.path.name}); ptxas: {_ptxas(b)}")
    print(f"phase 6 all six builds, started together: {build_s:.3f} s")
    g3, ell3, sb = setup_config3(device)
    err3, k3_ms, p3_ms, k3_bytes, k3_slots = phase_k3(device, ell3, sb)
    frac2, err2, k2_config3 = phase_k2(device, ell3, sb)
    torch.cuda.empty_cache()
    launches2, launches3, full_gff, full_mcmc, peaks3 = phase_config3(device, g3)
    config3_max_degree = g3.max_degree
    del ell3
    torch.cuda.empty_cache()
    l3, e3 = phase_frontier_config3(device, g3, full_gff)
    launches3, err3 = launches3 + l3, max(err3, e3)
    torch.cuda.empty_cache()
    t_slice6 = time.perf_counter()
    fr3_full, k2_fr3, f2, e2 = phase_frontier_mcmc_config3(device, g3, full_mcmc)
    frac2, err2 = max(frac2, f2), max(err2, e2)
    slice6_s = time.perf_counter() - t_slice6
    torch.cuda.empty_cache()
    t_slice9 = time.perf_counter()
    sh3_chain, sh3_k2, sh3_k3, e3 = phase_sharded_config3(device, g3)
    err3 = max(err3, e3)
    slice9_s = time.perf_counter() - t_slice9
    del g3
    torch.cuda.empty_cache()
    hash_k2, hash_k3, k5_entry = phase_hash_ell_config3(device)
    launches2, launches3 = launches2 + hash_k2, launches3 + hash_k3
    torch.cuda.empty_cache()
    g4, r4, gff4 = phase_config4(device)
    t_slice7 = time.perf_counter()
    k2_b4, k3_b4, f2, e2, e3 = phase_config4_bucketed(device, g4, r4, gff4)
    frac2, err2, err3 = max(frac2, f2), max(err2, e2), max(err3, e3)
    del r4, gff4
    torch.cuda.empty_cache()
    k2_b1m, k3_b1m, f2, e2, e3 = phase_ba1m_bucketed(device)
    frac2, err2, err3 = max(frac2, f2), max(err2, e2), max(err3, e3)
    slice7_s = time.perf_counter() - t_slice7
    torch.cuda.empty_cache()
    l2_bench, k2_bench, f2, e2, r1, r2 = phase_k2_vs_k1(device, c, g_bench)
    frac2, err2 = max(frac2, f2), max(err2, e2)
    luby_launches, luby_rounds, luby_k1 = phase_luby(device, g_bench)
    t_slice6 = time.perf_counter()
    res = phase_resident_frontier(device, g_bench, r_main, r1)
    frac2, err2 = max(frac2, res["frac"]), max(err2, res["qerr"])
    host_k1, k1_host_shape = phase_packed_host(device, g_bench, c, r1, r2)
    hast_k2, hast_k1 = phase_hastings_xla(device, g_bench)
    slice6_s += time.perf_counter() - t_slice6
    torch.cuda.empty_cache()
    t_slice8 = time.perf_counter()
    k2_st, k3_st, f2, e2, e3 = phase_stepped(device, g_bench)
    frac2, err2, err3 = max(frac2, f2), max(err2, e2), max(err3, e3)
    torch.cuda.empty_cache()
    ens = phase_ensembles(device, g_bench, g4)
    del g4
    res_ens, trace_k1 = phase_resident_ensemble(device, g_bench, c)
    frac2 = max(frac2, ens["frac"], res_ens["frac"])
    err2 = max(err2, ens["qerr"], res_ens["qerr"])
    err3 = max([err3] + [x["max_abs_err"] for x in ens["K3"] + res_ens["K3"]])
    slice8_s = time.perf_counter() - t_slice8
    del c
    torch.cuda.empty_cache()
    t_slice9 = time.perf_counter()
    sh_chain, sh_k2, sh_k3, f2, e2, e3 = phase_sharded(device, g_bench)
    frac2, err2, err3 = max(frac2, f2, sh_chain["frac"], sh3_chain["frac"]), max(
        err2, e2, sh_chain["qerr"], sh3_chain["qerr"]), max(err3, e3)
    with tempfile.TemporaryDirectory() as td:
        ckpt = os.path.join(td, "sharded.npz")
        ref, ref_chains = phase_sharded_resume(device, g_bench, ckpt)
        phase_two_ranks(device, g_bench, ckpt, ref, ref_chains)
    f2, e2, e3 = phase_sharded_offsets(device, g_bench)
    frac2, err2, err3 = max(frac2, f2), max(err2, e2), max(err3, e3)
    slice9_s += time.perf_counter() - t_slice9
    torch.cuda.empty_cache()
    t_slice10 = time.perf_counter()
    st_k1, st_k2, f2, e2, st_ref, st_first, _, k4_strips = phase_sharded_strips(device,
                                                                                  g_bench)
    frac2, err2 = max(frac2, f2), max(err2, e2)
    mm_k1, mm_k3, _, e3, _ = phase_sharded_matmul(device, g_bench)
    err3 = max(err3, e3)
    st2_k1 = phase_strips_two_ranks(device, st_ref, st_first)
    del st_first
    slice10_s = time.perf_counter() - t_slice10
    torch.cuda.empty_cache()
    t_slice11 = time.perf_counter()
    base_rows = phase_baseline_configs(device, config3_max_degree, peaks3)
    torch.cuda.empty_cache()
    val_k2, val_k3, f2, e2, e3 = phase_validation(device)
    frac2 = max(frac2, f2, base_rows["frac"])
    err2, err3 = max(err2, e2, base_rows["qerr"]), max(err3, e3)
    torch.cuda.empty_cache()
    mesh_s = phase_mesh_ensemble(device, g_bench, ens["reference"])
    slice11_s = time.perf_counter() - t_slice11
    torch.cuda.empty_cache()
    t_slice12 = time.perf_counter()
    an_k2, an_k3, f2, e2, e3 = phase_analysis(smi)
    frac2, err2, err3 = max(frac2, f2), max(err2, e2), max(err3, e3)
    slice12_s = time.perf_counter() - t_slice12
    t_cli = time.perf_counter()
    cli15_s, cli25_s, cli31_s, cli35_s = phase_clis()
    print(f"phases 15, 25, 31, 35 (the CLI lanes, concurrent) {time.perf_counter() - t_cli:.3f} "
          f"s; lanes: phase 15 {cli15_s:.3f} s, 25 {cli25_s:.3f} s, 31 {cli31_s:.3f} s, 35 "
          f"{cli35_s:.3f} s; phases 16-19 (slice 6) {slice6_s:.3f} s; phases 20-21 (slice 7) "
          f"{slice7_s:.3f} s; phases 22-24 (slice 8) {slice8_s:.3f} s; phases 26-30 (slice 9) "
          f"{slice9_s:.3f} s; phases 32-34 (slice 10) {slice10_s:.3f} s; phases 36-38 (slice 11) "
          f"{slice11_s:.3f} s, of which phase 38's gloo spawn {mesh_s:.3f} s; phase 39 (slice 12) "
          f"{slice12_s:.3f} s")

    # no single PyTorch call computes what K1, K2 or K3 compute from their
    # inputs (PERF.md): library_ms is null
    # K1 ran at four shapes on the main paths: the resident chain's
    # palette (phase 4; also the resident frontier's full sweeps, cnt and
    # NC tailcut, phase 17, and the resident Hastings chain, phase 19),
    # resident Luby's two, one launch each a round (phase 14), and the
    # host graph's packed chain (phase 18, n_pad 131,072); its times are
    # their means weighted by those launches
    # (phase 24's resident TRACE run counts on the resident chain's row: its
    # sweeps, TRACE counts and tailcut all run K1 at that shape)
    k1_shapes = [("resident chain", chain_ncp, launches + res["k1"] + hast_k1 + trace_k1, err,
                  k_ms, p_ms, k1_bytes, k1_bits)]
    k1_shapes += [(f"resident Luby {ncp}", ncp, luby_rounds, *rest) for ncp, *rest in luby_k1]
    k1_shapes += [("host-graph packed chain", k1_host_shape[0], host_k1, *k1_host_shape[1:])]
    k1_rows = []
    for label, ncp, n, e, ms, pms, n_bytes, ops in k1_shapes:
        b_ms, b_by = _bound(n_bytes, ops, INT32_OPS_PER_S)
        k1_rows.append({"shape": label, "n_col_pad": ncp, "launches": n, "max_abs_err": e,
                        "ms": ms, "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by})
    # slice 8: K1 with a chain axis (phase 24's resident and matmul
    # ensembles), one row a shape, timed beside its chains' single launches;
    # slice 10: K1 at the sharded strips' call site, a row for each launch
    # shape of phases 32 (resident strips, with the tailcut's one-chain
    # launches) and 33 (the host graph's strips), and phase 34's shard of
    # (1, 2), whose launches are the two ranks'
    strip_k1 = st_k1 + mm_k1 + [st2_k1]
    for row in res_ens["K1"] + strip_k1:
        b_ms, b_by = _bound(row["bytes"], row["ops"], INT32_OPS_PER_S)
        k1_rows.append({**row, "bound_ms": b_ms, "bound_by": b_by})
    k1_n = sum(x["launches"] for x in k1_rows)

    def weighted(rows, key):
        return sum(x[key] * x["launches"] for x in rows) / sum(x["launches"] for x in rows)

    k1_ms, k1_bound = weighted(k1_rows, "ms"), weighted(k1_rows, "bound_ms")
    _require(k1_n == launches + luby_launches + res["k1"] + host_k1 + hast_k1 + trace_k1
             + sum(x["launches"] for x in res_ens["K1"] + strip_k1),
             "K1 launches by shape do not add up")
    # K2 ran on the main paths one launch a sweep at the config-3 sweep in
    # the L2 regime (phases 9 and 16) and the ER(100k, 0.01) sweep staged
    # (phases 11 and 19), one a frontier iteration at each (palette, cap)
    # of the config-3 frontier (L2, phase 16) and the resident frontier
    # (staged, phase 17), and at every shape of config 4's runs, flat and
    # bucketed (one launch a degree class a sweep), and of BA(1M, 8)
    # (phases 20, 21); weighted the same way
    _require(sum(x["launches"] for x in res["k2_rows"]) == res["k2"],
             "resident frontier K2 launches by cap do not add up")
    k2_rows = []
    # slice 8: the stepped and traced chains' shapes (phase 22), and K2 with
    # a chain axis at each shape of phase 23's ensembles
    # slice 9: the sharded ensemble's K2 at its call sites (phases 26 and
    # 27): the full sweep with a chain axis, the frontier's rows
    # slice 11: config 5's 64 chains (phase 36) and the validation
    # scripts' one-chain runs (phase 37); slice 12: the analysis batch's
    # device chains (phase 39)
    for row in ([{**k2_config3, "launches": launches2 + fr3_full},
                 {**k2_bench, "launches": l2_bench + hast_k2}] + k2_fr3 + res["k2_rows"]
                + k2_b4 + k2_b1m + k2_st + ens["K2"] + res_ens["K2"]
                + sh_chain["K2"] + sh_k2 + sh3_chain["K2"] + sh3_k2 + st_k2
                + base_rows["K2"] + val_k2 + an_k2):
        b_ms, b_by = _bound(row["bytes"], row["ops"], FP32_OPS_PER_S)
        k2_rows.append({**row, "bound_ms": b_ms, "bound_by": b_by,
                        "bound_share": b_ms / row["ms"]})
    k2_ms, k2_bound = weighted(k2_rows, "ms"), weighted(k2_rows, "bound_ms")
    # K3: every launch of phases 7-13 is counted on the config-3 band's row
    # (the shape it was timed at); config 4's and BA(1M, 8)'s launches by
    # shape (phases 20, 21)
    k3_rows = []
    for row in ([{"shape": "config-3 band", "launches": launches3, "max_abs_err": err3,
                  "ms": k3_ms, "plain_ms": p3_ms, "bytes": k3_bytes, "ops": k3_slots}]
                + k3_b4 + k3_b1m + k3_st + ens["K3"] + res_ens["K3"]
                + sh_chain["K3"] + sh_k3 + sh3_chain["K3"] + sh3_k3 + mm_k3
                + val_k3 + an_k3):  # the matrix cells' (37) and the batch's (39) tailcuts
        b_ms, b_by = _bound(row["bytes"], row["ops"], INT32_OPS_PER_S)
        k3_rows.append({**row, "bound_ms": b_ms, "bound_by": b_by,
                        "bound_share": b_ms / row["ms"]})
    k3_ms, k3_bound = weighted(k3_rows, "ms"), weighted(k3_rows, "bound_ms")

    print(json.dumps({"kernels": [
        {
            "name": "packed_nc",
            "route": "cuda",
            "source": "mcmc_colorer_tpu_torch/csrc/packed_nc.cu",
            "replaces": "mcmc_colorer_tpu/ops/pallas_bitmatmul.py:92",
            "launches": k1_n,
            "max_abs_err": max(x["max_abs_err"] for x in k1_rows),
            "ms": k1_ms,
            "plain_ms": weighted(k1_rows, "plain_ms"),
            "bound_ms": k1_bound,
            "bound_by": "bytes" if all(x["bound_by"] == "bytes" for x in k1_rows)
            else "operations",
            "bound_share": k1_bound / k1_ms,
            "library_ms": None,
            "shapes": k1_rows,
        },
        {
            "name": "resample_sweep",
            "route": "cuda",
            "source": "mcmc_colorer_tpu_torch/csrc/resample.cu",
            "replaces": "mcmc_colorer_tpu/ops/pallas_resample.py:451",
            "launches": sum(x["launches"] for x in k2_rows),
            "max_abs_err": err2,  # of qstar, where the sampled colours agree
            "boundary_fraction": frac2,
            "ms": k2_ms,
            "plain_ms": weighted(k2_rows, "plain_ms"),
            "bound_ms": k2_bound,
            "bound_by": "bytes" if all(x["bound_by"] == "bytes" for x in k2_rows)
            else "operations",
            "bound_share": k2_bound / k2_ms,
            "library_ms": None,
            "shapes": k2_rows,
        },
        {
            "name": "first_fit",
            "route": "cuda",
            "source": "mcmc_colorer_tpu_torch/csrc/first_fit.cu",
            "replaces": "mcmc_colorer_tpu/ops/pallas_firstfit.py:147",
            "launches": sum(x["launches"] for x in k3_rows),
            "max_abs_err": err3,
            "ms": k3_ms,
            "plain_ms": weighted(k3_rows, "plain_ms"),
            # an OR a neighbour
            "bound_ms": k3_bound,
            "bound_by": "bytes" if all(x["bound_by"] == "bytes" for x in k3_rows)
            else "operations",
            "bound_share": k3_bound / k3_ms,
            "library_ms": None,
            "shapes": k3_rows,
        },
        _k4_summary(k4_rows, k4_chain, k4_strips),
        k5_entry,
        k6_entry,
    ]}))
    import torch.distributed as dist

    if dist.is_initialized():  # phase 26's one-rank NCCL group
        dist.destroy_process_group()
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
