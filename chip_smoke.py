#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mcmc_colorer_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every kernel of the resident main path from ``csrc/``, holds
each against its plain PyTorch version on the card, checks the hash
generator word for word, then drives the main path once at the bench
configuration, ER(n=100k, p=0.01) with balance-dynamic proposals and the
tailcut, and checks the colouring against the host's C++ re-derivation
of the graph.  A tight-palette run exercises the tailcut.  Any failed
check raises, so the exit code is non-zero.  Without CUDA, or outside a
checkout, it exits non-zero before printing any result.

The last line of standard output is one JSON object naming the device;
the line before it holds the kernels' launch counts, errors and times.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the three shapes of tests/test_matmul_backend.py:test_packed_nc_pallas_matches_dense,
# and a palette wide enough (8064 padded colours) that K1 takes fewer rows
# per block and more than 48 KB of shared memory
K1_SHAPES = [(1500, 0.05, 150), (4700, 0.01, 1100), (640, 0.3, 64), (3000, 0.5, 8000)]
BENCH_N, BENCH_P = 100_000, 0.01
TIMED_RUNS = 10


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _median_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median CUDA-event time of ``fn`` over ``runs`` calls, after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _random_colors(n: int, n_pad: int, n_colors: int, gen, device):
    """Colours in [0, n_colors) for real vertices, -1 for phantoms."""
    import torch

    c = torch.randint(0, n_colors, (n_pad,), generator=gen, device=device,
                      dtype=torch.int32)
    c[n:] = -1
    return c


def phase_k1(device, shapes, bench_n_pad=None, bench_colors=1152, seed=5):
    """K1 against its plain version, exactly, at ``shapes`` and (if given)
    at the bench shape, where both are also timed.  Returns
    (max_abs_err, kernel_ms, plain_ms)."""
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
    if bench_n_pad is None:
        return err, None, None
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
    print(
        f"phase 2 K1 bench shape n_pad={bench_n_pad} words={adj.shape[1]} "
        f"n_col_pad={ncp} set_bits={set_bits}: exact; "
        f"kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"(median of {TIMED_RUNS}, CUDA events)"
    )
    return max(err, e), kernel_ms, plain_ms


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
    """Hash generator on ``device`` against the numpy oracle, word for word."""
    import numpy as np

    from mcmc_colorer_tpu_torch.interop import adjacency_to_jax
    from mcmc_colorer_tpu_torch.ops.hashgen import (
        degrees_from_packed, er_packed_on_device, hash_edges_reference,
    )

    n_pad = _round_up(n, 2048)
    adj = er_packed_on_device(n, p, seed, n_pad, device=device)
    edges = hash_edges_reference(n, p, seed)
    want = _pack_edges_host(edges, n_pad)
    got = adjacency_to_jax(adj)
    _require(np.array_equal(got, want), f"hash words differ at n={n}")
    deg = degrees_from_packed(adj).cpu().numpy()[:n]
    want_deg = np.bincount(edges.ravel(), minlength=n)
    _require(np.array_equal(deg, want_deg), "degrees differ from the oracle")
    print(
        f"phase 3 hash n={n} n_pad={n_pad} words={adj.shape[1]} "
        f"edges={edges.shape[0]}: words and degrees exact"
    )


def phase_main(device, n=BENCH_N, p=BENCH_P, graph_seed=0, seed=5):
    """The main path, once, through the library surface; returns
    (coloring, colorer, K1 launches during it)."""
    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.models.base import check_coloring
    from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer
    from mcmc_colorer_tpu_torch.ops import packed_nc as k1

    params = MCMCParams(n_colors=0, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    k1.launches = 0
    t0 = time.perf_counter()
    c = ResidentMCMCColorer(n, p, graph_seed=graph_seed, params=params, device=device)
    r = c.run(seed=seed)
    wall = time.perf_counter() - t0
    launches = k1.launches
    x = r.extra
    print(
        f"phase 4 main ER({n}, {p}) n_colors={c.params.n_colors} "
        f"edges={c.n_edges} max_degree={c.max_degree}: "
        f"gen {x['gen_seconds']:.3f} s; iterations {r.iterations}, "
        f"sweeps {x['sweeps']}, tailcut rounds {x['tailcut_rounds']}; "
        f"chain {x['chain_seconds']:.3f} s, after chain {x['tailcut_seconds']:.3f} s, "
        f"run {r.duration_ms / 1e3:.3f} s, wall {wall:.3f} s; "
        f"{x['chain_seconds'] / max(x['sweeps'], 1) * 1e3:.3f} ms/sweep; "
        f"K1 launches {launches}"
    )
    _require(launches > 0, "the main path launched K1 no time")
    t0 = time.perf_counter()
    g = c.host_graph()
    host_s = time.perf_counter() - t0
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
    return r, c, launches


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "mcmc_colorer_tpu_torch" / "csrc" / "packed_nc.cu").is_file():
        raise SystemExit(f"chip_smoke.py: {ROOT} is not a checkout of the repository")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"phase 0 card: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"python {sys.version.split()[0]}")

    from mcmc_colorer_tpu_torch.ops import packed_nc as k1

    built = k1.load_kernel()
    ptxas = " | ".join(
        ln.strip() for ln in built.log.splitlines() if "registers" in ln or "smem" in ln
    )
    print(f"phase 1 build K1: {built.seconds:.3f} s ({built.path.name}); ptxas: {ptxas}")

    err, k_ms, p_ms = phase_k1(device, K1_SHAPES, bench_n_pad=_round_up(BENCH_N, 2048))
    torch.cuda.empty_cache()
    phase_hash(device)
    _, _, launches = phase_main(device)
    phase_tight(device)

    print(json.dumps({"kernels": [{
        "name": "packed_nc",
        "route": "cuda",
        "source": "mcmc_colorer_tpu_torch/csrc/packed_nc.cu",
        "replaces": "mcmc_colorer_tpu/ops/pallas_bitmatmul.py:92",
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
