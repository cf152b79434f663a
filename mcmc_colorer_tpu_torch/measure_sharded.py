"""The sharded ensemble on the card: where a sweep's device time goes, and
what gloo's collectives cost between two ranks that share the card.

    python3 -m mcmc_colorer_tpu_torch.measure_sharded [--out PATH]

Needs one CUDA device.  At ER(100k, 0.01) (the resident bench's hash
graph, graph seed 0; its host CSR), 8 chains, nCol = max degree,
balance-dynamic, tailcut, seed 5, ``ShardedMCMCColorer(backend="pallas")``
runs on a 1x1 mesh without a process group, with full sweeps and with
the frontier (ε 5e-9, ``active_cap = n // 8``, as ``chip_smoke.py``
phase 26), and so does the colorer on the hash graph's strips
(``resident_spec``, K1 and the proposal read from NC; ``chip_smoke.py``
phase 32): each once to warm up, then once under ``torch.profiler``,
which gives the run's device time by operation (the top 12) beside its
sweeps and chain seconds.  Then two gloo ranks spawned on the card time the
sharded colorer's collectives on CUDA tensors (medians of 20 calls): the
shard all-gather of [8, 51,200] int32 (a (1, 2) full sweep's colours at
8 chains), the all-reduce of the [100,352] int32 cnt delta (a frontier
sweep's) and ``gather_ranks`` of [8, 5] int64 (a sweep's statistics).
The result goes to ``--out`` as JSON, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import time
from pathlib import Path

import torch

GRAPH = (100_000, 0.01, 0)   # n, p, graph seed: the resident bench
SEED, CHAINS = 5, 8
FRONTIER_EPS = 5e-9
CALLS = 20


def _graph():
    from mcmc_colorer_tpu_torch.ops.hashgen import hash_er_graph

    return hash_er_graph(*GRAPH)


def profile_runs() -> dict:
    """Device time by operation of one warm run, full sweeps and frontier."""
    from torch.profiler import ProfilerActivity, profile

    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.parallel.mesh import make_mesh
    from mcmc_colorer_tpu_torch.parallel.sharded import ShardedMCMCColorer

    g = _graph()
    mesh = make_mesh(1, 1)
    out = {}
    frontier = ({"epsilon": FRONTIER_EPS}, {"active_cap": g.n // 8})
    strips = {"resident_spec": GRAPH}
    for name, pkw, ckw in (("full", {}, {"backend": "pallas"}),
                           ("frontier", frontier[0], {**frontier[1], "backend": "pallas"}),
                           ("resident strips full", {}, strips),
                           ("resident strips frontier", frontier[0], {**frontier[1], **strips})):
        params = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC,
                            tailcut=True, **pkw)
        graph = None if "resident_spec" in ckw else g
        c = ShardedMCMCColorer(graph, params, mesh, n_chains=CHAINS, **ckw)
        c.run(seed=SEED)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            best, _ = c.run(seed=SEED)
            torch.cuda.synchronize()
        events = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
        out[name] = {
            "sweeps": best.iterations,
            "frontier_sweeps_best": best.extra["frontier_sweeps"],
            "chain_seconds": best.extra["chain_seconds"],
            "device_ms_total": sum(e.self_device_time_total for e in events) / 1e3,
            "top_device_ms": [(e.key[:80], e.self_device_time_total / 1e3, e.count)
                              for e in events[:12]],
        }
    return out


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _median_ms(fn) -> float:
    times = []
    for _ in range(CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _gloo_rank(rank: int, port: int, out: str) -> None:
    import torch.distributed as dist

    from mcmc_colorer_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    torch.cuda.set_device(0)
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
                           backend="gloo")
    mesh = make_mesh(1, 2)
    dev = mesh.device
    colours = torch.zeros((CHAINS, 51_200), dtype=torch.int32, device=dev)
    delta = torch.zeros((100_352,), dtype=torch.int32, device=dev)
    stats = torch.zeros((CHAINS, 5), dtype=torch.int64, device=dev)
    got = {"device": str(dev)}
    calls = (("all_gather_shards [8, 51200] int32", lambda: mesh.all_gather_shards(colours)),
             ("all_reduce_shards [100352] int32", lambda: mesh.all_reduce_shards(delta)),
             ("gather_ranks [8, 5] int64", lambda: mesh.gather_ranks(stats)))
    for name, fn in calls:
        fn()  # warm-up
        got[name] = _median_ms(fn)
    if rank == 0:
        Path(out).write_text(json.dumps(got))
    dist.destroy_process_group()


def gloo_collectives(deadline_s: float = 300.0) -> dict:
    """Two gloo ranks spawned on the card: median ms of the collectives."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as td:
        out = str(Path(td) / "gloo.json")
        ctx = mp.start_processes(_gloo_rank, args=(_free_port(), out), nprocs=2, join=False,
                                 start_method="spawn")
        t0 = time.perf_counter()
        try:
            while not ctx.join(timeout=1.0):
                if time.perf_counter() - t0 > deadline_s:
                    raise RuntimeError(f"the gloo ranks still run after {deadline_s} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        return json.loads(Path(out).read_text())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the JSON result here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("measure_sharded: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    result = {"card": card, "profile": profile_runs(), "gloo": gloo_collectives()}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
