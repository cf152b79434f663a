"""The port's ``EnsembleMCMCColorer(mesh=)`` against JAX's ensemble on a
mesh, on the CPU.

- JAX's ``EnsembleMCMCColorer(mesh=make_mesh(chains=8, shards=1))`` on
  the 8 virtual CPU devices (``tests/conftest.py``) runs 8 chains; the
  port runs them over two spawned ``gloo`` ranks at (2, 1), each rank
  its 4 chains fed JAX's draws for them (``test_torch_ensemble.
  jax_chain_draws``).  Every rank's best chain, colours, trace,
  summaries and JAX's ``extra`` equal JAX's (exact).
- On the port's own draws the (2, 1) ranks equal the one-rank ensemble
  (chain c draws from its own source on any mesh), and so does a 1x1 mesh
  without a process group.
- The refusals: a mesh without a ``chains`` axis, and ``n_chains`` not a
  multiple of the mesh's chain groups.
"""

import os
import pickle
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mcmc_colorer_tpu.config import MCMCParams as JParams
from mcmc_colorer_tpu.config import ProposalKind as JKind
from mcmc_colorer_tpu.parallel.chains import EnsembleMCMCColorer as JEnsemble
from mcmc_colorer_tpu.parallel.mesh import make_mesh as j_make_mesh

from mcmc_colorer_tpu_torch import interop
from mcmc_colorer_tpu_torch.models.base import check_coloring
from mcmc_colorer_tpu_torch.parallel.chains import EnsembleMCMCColorer
from mcmc_colorer_tpu_torch.parallel.mesh import Mesh, initialize_distributed, make_mesh
from mcmc_colorer_tpu_torch.utils.rng import ChainSources

from test_torch_active import Replay
from test_torch_ensemble import jax_chain_draws
from test_torch_mcmc import port_params

torch.set_num_threads(2)

DEADLINE_S = 150.0  # the spawn's limit: several times its ~15 s
SEED, N_CHAINS = 21, 8


def _jax_params(max_degree):
    return JParams(n_colors=max(4, max_degree // 2), tailcut=True,
                   proposal=JKind.BALANCE_DYNAMIC, taboo_iterations=1)


def digest(result):
    """Best colours, iterations, trace, summaries, and ``extra`` without
    its time."""
    best, summaries = result
    return (np.asarray(best.colors), best.iterations, np.asarray(best.conflict_trace),
            {k: v for k, v in best.extra.items() if k != "chain_seconds"}, summaries,
            best.converged)


def _rank_main(rank, world, rdv, out_dir, job):
    """One spawned rank: join the gloo group, run the job on its (2, 1)
    mesh, write its digests."""
    torch.set_num_threads(1)
    initialize_distributed(init_method=f"file://{rdv}", world_size=world, rank=rank,
                           backend="gloo")
    try:
        mesh = make_mesh(2, 1, device="cpu")
        ens = EnsembleMCMCColorer(job["graph"], job["params"], N_CHAINS, mesh=mesh,
                                  backend="xla")
        k = ens.local_chains
        sources = ChainSources([Replay(job["draws"][c])
                                for c in range(ens.first_chain, ens.first_chain + k)], "cpu")
        out = {"replay": digest(ens.run(SEED, sources=sources)), "own": digest(ens.run(SEED)),
               "chains": (ens.first_chain, k)}
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn_and_join(job, world, tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp_path / "rdv"), str(out), job),
                             nprocs=world, join=False, start_method="spawn")
    t_end = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > t_end:
                pytest.fail(f"spawned ranks still running after {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [pickle.loads((out / f"{r}.pkl").read_bytes()) for r in range(world)]


def test_mesh_ensemble_matches_jax_over_two_ranks(medium_er, tmp_path):
    jp = _jax_params(medium_er.max_degree)
    jmesh = j_make_mesh(chains=8, shards=1)
    want_best, want = JEnsemble(medium_er, jp, n_chains=N_CHAINS, mesh=jmesh,
                                backend="xla").run(seed=SEED)
    g, p = interop.graph_from_jax(medium_er), port_params(jp)
    one = EnsembleMCMCColorer(g, p, N_CHAINS, backend="xla", device="cpu")
    draws = [jax_chain_draws(SEED, c, one.ell.n_pad, jp.n_colors, want[c]["iterations"],
                             False) for c in range(N_CHAINS)]
    ranks = _spawn_and_join({"graph": g, "params": p, "draws": draws}, 2, tmp_path)
    own = digest(one.run(SEED))
    assert [r["chains"] for r in ranks] == [(0, 4), (4, 4)]
    for got in ranks:
        colors, iterations, trace, extra, summaries, _ = got["replay"]
        assert summaries == want
        assert extra["best_chain"] == want_best.extra["best_chain"]
        assert np.array_equal(colors, want_best.colors)
        assert iterations == want_best.iterations
        assert np.array_equal(trace, np.asarray(want_best.conflict_trace))
        assert {k: extra[k] for k in want_best.extra} == want_best.extra
        for a, b in zip(got["own"], own):  # geometry-free: equal to one rank
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b)
            else:
                assert a == b
    assert len({s["iterations"] for s in want}) > 1  # the chains end apart
    assert check_coloring(g, ranks[0]["replay"][0])


def test_one_by_one_mesh_runs_locally(medium_er):
    """A 1x1 mesh without a process group: no collective, the same result
    as ``mesh=None``."""
    g = interop.graph_from_jax(medium_er)
    p = port_params(_jax_params(medium_er.max_degree))
    want = digest(EnsembleMCMCColorer(g, p, 3, device="cpu").run(seed=SEED))
    got = digest(EnsembleMCMCColorer(g, p, 3, mesh=make_mesh(1, 1, device="cpu")).run(seed=SEED))
    for a, b in zip(got, want):
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b


def test_mesh_refusals(small_er):
    """JAX's refusals (``parallel/chains.py:189-196``), and sources that are
    not this rank's chains."""
    g = interop.graph_from_jax(small_er)
    p = port_params(_jax_params(small_er.max_degree))
    with pytest.raises(ValueError, match="'chains' axis"):
        EnsembleMCMCColorer(g, p, 4, mesh=SimpleNamespace(shape={"shards": 1}))
    two_groups = Mesh(2, 1, 0, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by mesh chains=2"):
        EnsembleMCMCColorer(g, p, 3, mesh=two_groups)
    ens = EnsembleMCMCColorer(g, p, 4, mesh=two_groups)
    assert (ens.local_chains, ens.first_chain) == (2, 0)
    with pytest.raises(ValueError, match="this rank's 2 chains"):
        ens.run(SEED, sources=ChainSources.seeded(SEED, 0, 4, "cpu"))
