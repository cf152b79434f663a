"""The port's sharded ensemble over spawned ``gloo`` ranks, against the
JAX package's ``ShardedMCMCColorer`` on the same mesh of the 8 virtual CPU
devices (``tests/conftest.py``), on the CPU.

Each geometry — (1, 2), (2, 1) and (2, 2) — is one spawn of its ranks
(``torch.multiprocessing``, ``init_method="file://..."``) running several
cases, while this process runs JAX's; the spawn joins with its own
deadline and kills its ranks when it passes, so a hung collective fails
the test instead of stalling the suite.

- On JAX's replayed draws (``test_torch_sharded.JaxChainSource``: every
  shard's ``fold_in`` draws, concatenated) every rank's colours,
  iterations, trace, summaries and JAX's ``extra`` equal JAX's (exact):
  full sweeps, the frontier, Hastings (its shard sums) and annealing,
  and at (1, 2) the sharded tailcut; on the adjacency strips too (cases
  ``mm_*``: backend ``matmul`` over the host graph; ``res_*``: the
  resident hash strips, each rank generating its own, with the strip
  tailcut's coins replayed at (1, 2) by
  ``test_torch_sharded_strips.JaxStripTailcutSource``), and the banded
  degree pass over the mesh equals JAX's.
- On the port's own draws, full sweeps do not depend on the geometry: the
  run at each mesh equals the 1x1 run at the same chain count, chain by
  chain (exact), and a checkpoint written at 1x1 after 2 sweeps resumes
  there equal to the uninterrupted 1x1 run (re-sharding), for the ELL
  and for the resident strips; the strip tailcut's capped end (its
  serial first-free pass, a collective a vertex) equals the 1x1 one.
- The CLI under ``torchrun`` with 2 ranks (``--mesh-shards 2 --device
  cpu``): exit 0, a valid colouring, rank 0 alone writing the files; over
  a host graph with ``--backend packed``, and on the resident strips.
"""

import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mcmc_colorer_tpu.graph.generate import erdos_renyi as j_er
from mcmc_colorer_tpu.parallel.mesh import make_mesh as j_make_mesh
from mcmc_colorer_tpu.parallel.sharded import ShardedMCMCColorer as JSharded

from mcmc_colorer_tpu_torch import interop
from mcmc_colorer_tpu_torch.models.base import check_coloring
from mcmc_colorer_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from mcmc_colorer_tpu_torch.parallel.sharded import ShardedMCMCColorer

from test_torch_sharded import TIMES, case_setup, exercised, jax_sources
from test_torch_sharded_strips import SPEC, replay, run_setup, strip_finish
from test_torch_sharded_strips import exercised as strips_exercised

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 150.0  # a spawn's limit: several times its ~10 s
SEED = 21


def _graph():
    """tests/conftest.py's medium_er, made again in each rank."""
    return j_er(500, 0.05, seed=3)


def digest(result):
    """What two runs must share: best colours, iterations, trace, the
    summaries and extra (but times), convergence."""
    best, summaries = result
    return (np.asarray(best.colors), best.iterations, np.asarray(best.conflict_trace),
            {k: v for k, v in best.extra.items() if k not in TIMES}, summaries, best.converged)


def assert_same(got, want):
    """Equal digests, ``extra`` compared on ``want``'s keys (JAX's)."""
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert np.array_equal(got[2], want[2])
    assert {k: got[3][k] for k in want[3]} == want[3]
    assert got[4] == want[4] and got[5] == want[5]


def _spec_max_degree():
    from mcmc_colorer_tpu_torch.graph.native import generate_er_hash
    from mcmc_colorer_tpu_torch.ops.hashgen import er_threshold

    n, prob, seed = SPEC
    return generate_er_hash(n, er_threshold(prob), seed).max_degree


def _setup(case):
    """(JAX params, port params, JAX kwargs, port kwargs, resident) of a
    case: ``test_torch_sharded.CASES`` over the graph, ``mm_<run>`` and
    ``res_<run>`` ``test_torch_sharded_strips.RUNS`` on the strips of the
    graph (backend ``matmul``) and of ``SPEC`` (``resident_spec``)."""
    if case.startswith("mm_"):
        jp, p, jkw, kw = run_setup(_graph().max_degree, case[3:])
        return jp, p, {**jkw, "backend": "matmul"}, {**kw, "backend": "matmul"}, False
    if case.startswith("res_"):
        jp, p, jkw, kw = run_setup(_spec_max_degree(), case[4:])
        return jp, p, {**jkw, "resident_spec": SPEC}, {**kw, "resident_spec": SPEC}, True
    return (*case_setup(_graph(), case), False)


def _colorer(mesh, case, n_chains):
    _, p, _, kw, resident = _setup(case)
    graph = None if resident else interop.graph_from_jax(_graph())
    return ShardedMCMCColorer(graph, p, mesh, n_chains=n_chains, **kw), p


def _run_case(mesh, case, n_chains, replay_draws, resume_from=None):
    if case == "degrees":  # the banded degree pass over the mesh
        from mcmc_colorer_tpu_torch.ops.hashgen import er_degrees_on_device

        return er_degrees_on_device(*SPEC, row_chunk=128, mesh=mesh).numpy()
    if case == "finish":  # the strip tailcut's capped end over the mesh
        return strip_finish(mesh)[:3]
    c, p = _colorer(mesh, case, n_chains)
    run_kw = {"resume_from": resume_from} if resume_from else {}
    if replay_draws:
        if case.startswith(("mm_", "res_")):
            srcs, tsrc = replay(SEED, n_chains, mesh.shards, c, c.graph.n, p.n_colors,
                                strips_tailcut=case.startswith("res_"))
        else:
            srcs, tsrc = jax_sources(SEED, n_chains, mesh.shards, c.n_loc, c.graph.n,
                                     p.n_colors, c.active_cap)
        run_kw.update(sources=srcs, tailcut_source=tsrc)
    return digest(c.run(seed=SEED, **run_kw))


def _rank_main(rank, world, rdv, out_dir, job):
    """One spawned rank: join the gloo group, run the job's cases on its
    mesh, write their digests."""
    torch.set_num_threads(1)
    initialize_distributed(init_method=f"file://{rdv}", world_size=world, rank=rank,
                           backend="gloo")
    try:
        mesh = make_mesh(*job["mesh"], device="cpu")
        out = {name: _run_case(mesh, case, n, replay_draws,
                               job["ckpt"][case] if resume else None)
               for name, case, n, replay_draws, resume in job["runs"]}
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(job, world, tmp_path):
    """Start ``world`` ranks on ``job`` without waiting."""
    out = tmp_path / "out"
    out.mkdir()
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp_path / "rdv"), str(out), job),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, out


def join(ctx, out, world, deadline=DEADLINE_S):
    """Every rank's digests, or a failure once ``deadline`` seconds pass
    (the ranks are killed then)."""
    t_end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > t_end:
                pytest.fail(f"spawned ranks still running after {deadline} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [pickle.loads((out / f"{r}.pkl").read_bytes()) for r in range(world)]


def _one_by_one(case, n_chains, seed=SEED, steps=None, ckpt=None):
    """The port at 1x1 in this process on its own draws; with ``steps``,
    also its checkpoint after that many sweeps, written to ``ckpt``."""
    mesh = make_mesh(1, 1, device="cpu")
    if steps is not None:
        c, _ = _colorer(mesh, case, n_chains)
        c.save_checkpoint(c._run_sharded_segment(c.init_state(seed), steps), ckpt)
    return digest(_colorer(mesh, case, n_chains)[0].run(seed=seed))


# geometry -> (chains, JAX-replayed cases): each also runs, on its own
# draws, the "xla" case and the full-sweep resident strips, and the resume
# of each from a 1x1 checkpoint
GEOMETRIES = {
    (1, 2): (3, ["pallas_tailcut", "frontier_xla", "hastings_xla", "anneal", "mm_tailcut",
                 "res_tailcut", "res_frontier", "degrees"]),
    (2, 1): (2, ["xla", "frontier_pallas", "mm_hastings", "res_anneal"]),
    (2, 2): (4, ["xla", "frontier_xla", "mm_frontier", "res_full", "degrees"]),
}
OWN = ("xla", "res_full")


def _jax_run(case, jmesh, n_chains):
    if case == "degrees":
        from mcmc_colorer_tpu.ops.hashgen import er_degrees_on_device as j_degrees

        return np.asarray(j_degrees(*SPEC, row_chunk=128, mesh=jmesh))
    jp, _, jkw, _, resident = _setup(case)
    return digest(JSharded(None if resident else _graph(), jp, jmesh, n_chains=n_chains,
                           **jkw).run(seed=SEED))


@pytest.mark.parametrize("geometry", list(GEOMETRIES), ids=lambda g: f"{g[0]}x{g[1]}")
def test_ranks_match_jax_and_one_by_one(geometry, tmp_path):
    mc, ms = geometry
    n_chains, cases = GEOMETRIES[geometry]
    ckpt = {case: str(tmp_path / f"one_by_one_{case}.npz") for case in OWN}
    want_own = {case: _one_by_one(case, n_chains, steps=2, ckpt=ckpt[case]) for case in OWN}
    job = {"mesh": geometry, "ckpt": ckpt,
           "runs": [(case, case, n_chains, True, False) for case in cases]
           + [(f"own {case}", case, n_chains, False, False) for case in OWN]
           + [(f"resume {case}", case, n_chains, False, True) for case in OWN]
           + [("finish", "finish", n_chains, False, False)]}
    ctx, out = spawn(job, mc * ms, tmp_path)
    try:
        jmesh = j_make_mesh(mc, ms, devices=jax.devices()[:mc * ms])
        want = {case: _jax_run(case, jmesh, n_chains) for case in cases}
    finally:
        ranks = join(ctx, out, mc * ms)
    g = interop.graph_from_jax(_graph())
    cols, conf, rounds, want_finish = strip_finish(make_mesh(1, 1, device="cpu"))
    for got in ranks:
        assert got["finish"][1:] == (conf, rounds) == (0, 18)
        assert np.array_equal(got["finish"][0], cols) and np.array_equal(cols, want_finish)
        for case in cases:
            if case == "degrees":
                assert np.array_equal(got[case], want[case])
            else:
                assert_same(got[case], want[case])
        for case in OWN:
            assert_same(got[f"own {case}"], want_own[case])
            assert_same(got[f"resume {case}"], want_own[case])
    for case in cases:
        if case == "degrees":
            continue
        best, it, trace, extra, summaries, _ = ranks[0][case]
        if case.startswith(("mm_", "res_")):
            strips_exercised(case.split("_", 1)[1], SimpleNamespace(extra=extra), summaries)
        else:
            exercised(case, extra, summaries)
        if extra["final_conflicts"] == 0 and not case.startswith("res_"):
            assert check_coloring(g, best)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _torchrun_cli(tmp_path, *flags):
    """The CLI's sharded route under torchrun with 2 gloo ranks on
    ER(400, 0.05): exit 0, a VALID colouring, one log and one colour file
    (rank 0's)."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    args = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
            "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
            "-m", "mcmc_colorer_tpu_torch.cli", "--simulate", "0.05", "-n", "400", "--mcmcgpu",
            "--mesh-shards", "2", "--tailcut", "--check", "--seed", "5", "--device", "cpu",
            "--outDir", str(tmp_path / "out"), *flags]
    proc = subprocess.run(args, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=DEADLINE_S, stdin=subprocess.DEVNULL)
    assert proc.returncode == 0, proc.stderr[-3000:]
    files = sorted(os.listdir(tmp_path / "out"))
    assert len([f for f in files if f.endswith(".log")]) == 1, files
    assert len([f for f in files if f.endswith("-colors.txt")]) == 1, files
    assert proc.stdout.count("VALID") == 1 and "INVALID" not in proc.stdout, proc.stdout


def test_cli_under_torchrun(tmp_path):
    """Two gloo ranks started by torchrun run the CLI's sharded route:
    exit 0, a VALID colouring, one log and one colour file (rank 0's)."""
    _torchrun_cli(tmp_path)


@pytest.mark.parametrize("flags", [["--backend", "packed"], ["--resident", "--active"]],
                         ids=["backend_packed", "resident_active"])
def test_cli_strips_under_torchrun(tmp_path, flags):
    """The same on the adjacency strips: a host graph's (``--backend
    packed``) and the resident hash strips (with the frontier)."""
    _torchrun_cli(tmp_path, *flags)
