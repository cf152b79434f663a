"""The port's resident colorer against the JAX package's.

- Teacher-forced chain: JAX's ``_chain_segment_matmul`` is stepped one
  body at a time; from each JAX state, brought over with
  ``interop.carry_from_numpy``, the port runs one body on the uniform
  JAX drew for it.  Integer state (iteration, exit flag, conflict count,
  trace) must be equal; colours and taboo follow the sampling rule of
  ``test_torch_sweep.py`` (differences only at CDF-boundary vertices,
  at most 0.1 %), since XLA and torch add the float32 prefix sums in
  different orders.
- Whole slice: the port's own run (its own generator) must end with a
  valid colouring of the same graph as JAX's.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.config import MCMCParams as JParams
from mcmc_colorer_tpu.config import ProposalKind as JKind
from mcmc_colorer_tpu.models import mcmc as jm
from mcmc_colorer_tpu.models.mcmc_resident import ResidentMCMCColorer as JResident
from mcmc_colorer_tpu.ops import dense_adj as jd
from mcmc_colorer_tpu.ops.neighbor import color_histogram as j_hist
from mcmc_colorer_tpu.utils import rng as rngu

from mcmc_colorer_tpu_torch import interop
from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.models import mcmc as tm
from mcmc_colorer_tpu_torch.models.base import check_coloring
from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer
from mcmc_colorer_tpu_torch.ops import dense_adj as td
from mcmc_colorer_tpu_torch.utils.rng import ChainSources

torch.set_num_threads(2)

N, P, GRAPH_SEED = 1200, 0.04, 21
REPO = Path(__file__).resolve().parents[1]


class Replay:
    """A uniform source that hands out pre-drawn JAX uniforms in order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def next(self, n):
        u = self.draws.pop(0)
        assert u.shape == (n,), (u.shape, n)
        return torch.from_numpy(u)


def jax_uniform(key, n):
    return np.array(jax.random.uniform(key, (n,), dtype=jnp.float32))


@pytest.fixture(scope="module")
def jax_colorer():
    return JResident(N, P, graph_seed=GRAPH_SEED)


def tight(max_degree):
    return dict(n_colors=max(4, max_degree // 2), tailcut=True, max_iterations=60)


# Hastings at λ = 1 rejects every early proposal and at λ = 25 accepts
# some: three bodies each exercise both branches of the acceptance test
HASTINGS = {
    "hastings_reject": dict(hastings=True, lambda_=1.0, max_iterations=3),
    "hastings_accept": dict(hastings=True, lambda_=25.0, max_iterations=3),
}


def jax_cdf(c, carry):
    """JAX's cdf for the body that starts from ``carry``."""
    colors = carry[0]
    params = c.params
    nc = jd.neighbor_color_counts(c.adj, colors, params.n_colors, c.ell.node_mask)
    hist = j_hist(colors, params.n_colors, c.ell.node_mask)
    p_eff = jm._variant_distribution(params, hist, N)
    p_pad = jnp.zeros((nc.shape[1],), jnp.float32).at[: params.n_colors].set(p_eff)
    q = jm._proposal_q(colors, nc > 0, params, p_pad, n_colors=params.n_colors)
    return np.asarray(jnp.cumsum(q, axis=1))


@pytest.mark.parametrize("case", ["default", "tight", *HASTINGS])
def test_teacher_forced_chain(jax_colorer, case):
    from test_torch_sweep import assert_boundary_only

    if case == "default":
        c = jax_colorer
    else:
        kw = tight(jax_colorer.max_degree) if case == "tight" else dict(
            n_colors=jax_colorer.params.n_colors, tailcut=True, **HASTINGS[case]
        )
        c = JResident(
            N, P, graph_seed=GRAPH_SEED,
            params=JParams(proposal=JKind.BALANCE_DYNAMIC, **kw),
        )
    jp = c.params
    pt = MCMCParams(
        n_colors=jp.n_colors, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True,
        max_iterations=jp.max_iterations, hastings=jp.hastings, lambda_=jp.lambda_,
    )
    adj_t = interop.adjacency_from_jax(np.asarray(c.adj))
    n_pad = adj_t.shape[0]
    block = tm.choose_block_size(N, pt.n_colors)

    key = rngu.for_repetition(rngu.root_key(3), 0)
    carry = c._jit_init(c.ell, key)
    _, k_init = jax.random.split(key)
    init_t = tm._init_colors(n_pad, N, pt, Replay([jax_uniform(k_init, n_pad)]), "cpu")
    assert np.array_equal(init_t.numpy(), np.asarray(carry[0]))

    bodies, accepted = 0, 0
    while not bool(carry[6]) and int(carry[3]) < jp.max_iterations:
        if jp.hastings:
            _, k_u, k_acc = jax.random.split(carry[2], 3)
            u_acc = np.array([jax.random.uniform(k_acc, (), dtype=jnp.float32)])
        else:
            _, k_u = jax.random.split(carry[2])
        unif = jax_uniform(k_u, n_pad)
        source = Replay([unif.copy()] + ([u_acc] if jp.hastings else []))
        before = np.asarray(carry[0])
        state = interop.carry_from_numpy(*(np.asarray(carry[i]) for i in (0, 1, 3, 4, 5, 6)))
        # the chain core's body at one chain
        got = tm._chain_body(adj_t, state, np.ones(1, bool), params=pt, block=block, n_nodes=N,
                             sources=ChainSources([source], "cpu"), sweep=tm._sweep_matmul)
        assert not source.draws  # one draw per body, the last "done" body too
        cdf = jax_cdf(c, carry)
        carry = c._jit_segment(c.ell, c.adj, carry, jnp.int32(1))
        want = interop.carry_from_numpy(*(np.asarray(carry[i]) for i in (0, 1, 3, 4, 5, 6)))
        for f in ("rip", "conf_last", "done", "trace"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        mism = assert_boundary_only(got.colors[0].numpy(), want.colors[0].numpy(), unif, cdf,
                                    N)
        keep = np.ones(n_pad, bool)
        keep[mism] = False
        assert np.array_equal(got.taboo[0].numpy()[keep], want.taboo[0].numpy()[keep])
        accepted += not np.array_equal(want.colors[0].numpy(), before)
        bodies += 1
    assert bodies >= 2
    if case in HASTINGS:
        assert (accepted > 0) == (case == "hastings_accept")


def test_whole_slice_default_palette(jax_colorer):
    c = ResidentMCMCColorer(N, P, GRAPH_SEED, device="cpu")
    assert (c.n_edges, c.max_degree, c.params.n_colors) == (
        jax_colorer.n_edges, jax_colorer.max_degree, jax_colorer.params.n_colors
    )
    assert np.array_equal(c.host_degrees, jax_colorer.host_degrees)
    r = c.run(seed=3)
    assert r.extra["final_conflicts"] == 0
    assert r.colors.shape == (N,) and r.colors.max() < c.params.n_colors
    g = c.host_graph()
    assert g.n_edges == c.n_edges
    assert check_coloring(g, r.colors)
    s = c.stats_graph()
    assert (s.n, s.n_edges, s.max_degree) == (N, c.n_edges, c.max_degree)


def test_whole_slice_tight_palette():
    """Mirrors tests/test_resident.py:test_resident_tailcut_tight_palette."""
    c0 = ResidentMCMCColorer(N, P, graph_seed=GRAPH_SEED, device="cpu")
    p = MCMCParams(proposal=ProposalKind.BALANCE_DYNAMIC, **tight(c0.max_degree))
    c = ResidentMCMCColorer(N, P, graph_seed=GRAPH_SEED, params=p, device="cpu")
    r = c.run(seed=5)
    assert r.extra["final_conflicts"] == 0
    assert r.extra["tailcut_rounds"] >= 1
    assert check_coloring(c.host_graph(), r.colors)


def test_interop_round_trip(jax_colorer):
    a = np.asarray(jax_colorer.adj)
    assert np.array_equal(interop.adjacency_to_jax(interop.adjacency_from_jax(a)), a)
    carry = jax_colorer._jit_init(jax_colorer.ell, jax.random.key(1))
    fields = dict(
        colors=np.asarray(carry[0]), taboo=np.asarray(carry[1]) + 2,
        iteration=np.int32(7), conf_last=np.int32(42),
        trace=np.arange(jax_colorer.params.max_iterations + 1, dtype=np.int32),
        done=np.bool_(True),
    )
    back = interop.carry_to_numpy(interop.carry_from_numpy(**fields))
    assert back.keys() == fields.keys()
    for k, v in fields.items():
        assert np.array_equal(back[k], v), k


def test_unported_paths_raise(monkeypatch, tmp_path):
    """The paths ported since they raised here run: ensembles, the frontier
    mode, checkpoints and TRACE; what JAX refuses is still refused."""
    e = ResidentMCMCColorer(300, 0.05, 1, n_chains=2, device="cpu")
    best = e.run(seed=1)
    assert best.extra["chains"] == 2 and best.extra["final_conflicts"] == 0
    assert check_coloring(e.host_graph(), best.colors)
    # the frontier mode is ported: it runs to a valid colouring
    a = ResidentMCMCColorer(300, 0.05, 1, active=True, device="cpu")
    r = a.run(seed=1)
    assert r.extra["active"] and r.extra["final_conflicts"] == 0
    assert check_coloring(a.host_graph(), r.colors)
    with pytest.raises(NotImplementedError, match="checkpointing"):
        a.run(seed=1, checkpoint_path=str(tmp_path / "x"))
    with pytest.raises(NotImplementedError, match="single-chain"):
        ResidentMCMCColorer(300, 0.05, 1, n_chains=2, active=True, device="cpu")
    c = ResidentMCMCColorer(300, 0.05, 1, device="cpu")
    r1 = c.run(seed=1, checkpoint_path=str(tmp_path / "x"))
    assert (tmp_path / "x.npz").exists() and r1.iterations >= 1
    monkeypatch.setenv("MCMC_COLORER_TRACE", "1")
    r2 = c.run(seed=1)
    assert np.array_equal(r2.colors, r1.colors)
    assert len(r2.extra["free_color_trace_segments"]) >= 1
    with pytest.raises(ValueError, match="packed-adjacency HBM cap"):
        ResidentMCMCColorer(td.PACKED_ADJ_MAX_N + 1, 0.001, graph_seed=1, device="cpu")


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, load no jax and nothing
    of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "BAD = ('jax', 'jaxlib', 'mcmc_colorer_tpu')\n"
        "import mcmc_colorer_tpu_torch as m\n"
        "for x in pkgutil.walk_packages(m.__path__, m.__name__ + '.'):\n"
        "    importlib.import_module(x.name)\n"
        "import chip_smoke\n"
        "top = [k.split('.')[0] for k in sys.modules]\n"
        "print(top.count('mcmc_colorer_tpu_torch'), [k for k in top if k in BAD])\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.split()
    assert int(out[0]) > 10 and out[1] == "[]"


class InStep:
    """Coins alike for every vertex, heads and tails in turn: the two ends
    of a conflict flip the same coin round after round, so neither moves
    and the NC rounds reach their cap.  That is how one job of ER(100k,
    0.01) at nCol = max degree ended unfinished on an H100
    (``scripts/tailcut_cap_repro.py``).  ``next(n)`` is [n] (the strip
    tailcut's), ``next(n, running)`` [C, n] (``ChainSources``')."""

    def __init__(self):
        self.rounds = 0

    def next(self, n, running=None):
        self.rounds += 1
        shape = (n,) if running is None else (len(running), n)
        return torch.full(shape, 0.25 if self.rounds % 2 else 0.75)


def planted_conflict(n, p, seed, n_pad):
    """A capped case of the hash graph at nCol = its max degree: a proper
    first-fit colouring with one edge (u, v), u < v, made a conflict by
    giving v u's colour (an edge whose v has no other neighbour of that
    colour, so the conflicts are 1).  Returns (host graph, nCol, planted
    colours [n_pad] int32, u, the colours the serial first-free pass must
    give: u on its smallest colour no neighbour holds, v kept)."""
    from mcmc_colorer_tpu_torch.ops.hashgen import hash_er_graph

    g = hash_er_graph(n, p, seed)
    off = np.concatenate([[0], np.cumsum(g.degrees)])
    nbrs = [g.cols[off[v]:off[v + 1]] for v in range(n)]
    colors = np.zeros(n_pad, np.int32)
    for v in range(n):
        colors[v] = min(set(range(n)) - set(colors[nbrs[v][nbrs[v] < v]].tolist()))
    n_colors = int(g.max_degree)
    assert colors[:n].max() < n_colors
    u, v = next((u, v) for v in range(n) for u in nbrs[v][nbrs[v] < v].tolist()
                if (colors[nbrs[v]] == colors[u]).sum() == 1)
    planted = colors.copy()
    planted[v] = colors[u]
    want = planted.copy()
    want[u] = min(set(range(n_colors)) - set(planted[nbrs[u]].tolist()))
    return g, n_colors, planted, u, want


def _capped(thread_nc, z):
    """``planted_conflict``'s case through ``_tailcut_nc`` on ``InStep``
    coins: (host graph, planted, u, want, colours out, conflicts, rounds,
    coins drawn)."""
    from mcmc_colorer_tpu_torch.models import mcmc_resident as mr
    from mcmc_colorer_tpu_torch.ops.hashgen import er_packed_on_device

    n, p, seed, n_pad = 400, 0.05, 3, 512
    g, n_colors, planted, u, want = planted_conflict(n, p, seed, n_pad)
    adj = er_packed_on_device(n, p, seed, n_pad, row_chunk=256, device="cpu")
    node_mask = torch.arange(n_pad) < n
    t = torch.from_numpy(planted)[None]
    conf0 = mr.conflicts_from_packed(adj, t, n_colors, node_mask).numpy()
    assert conf0.tolist() == [1]
    coins = InStep()
    out, conf, rounds = mr._tailcut_nc(adj, t, conf0, ChainSources([coins], "cpu"), node_mask,
                                       n_colors=n_colors, thread_nc=thread_nc, z=z)
    assert np.array_equal(t[0].numpy(), planted)  # the input is not written
    return g, planted, u, want, out[0].numpy(), conf.tolist(), rounds.tolist(), coins.rounds


@pytest.mark.parametrize("thread_nc", [True, False], ids=["threaded_nc", "fresh_nc"])
def test_tailcut_cap_ends_with_a_first_free_pass(thread_nc):
    """A converged chain (1 conflict, under the tailcut threshold z = 50)
    whose NC rounds reach their cap with the conflict (both ends flipping
    alike) is finished by the serial first-free pass: the lower end takes
    its smallest free colour, the other keeps its own, and the colouring
    is proper."""
    g, planted, u, want, out, conf, rounds, drawn = _capped(thread_nc, z=50)
    assert rounds == [16 + 2] and drawn == 18 and conf == [0]
    assert np.array_equal(out, want) and out[u] != planted[u]
    assert check_coloring(g, out[:g.n])


def test_tailcut_cap_leaves_a_chain_that_did_not_converge_unfinished():
    """A chain that came in with more conflicts than the tailcut threshold
    (here z = 0) ends at its cap with its conflict, its colours as the
    rounds left them, as in JAX: the serial pass finishes only a
    converged chain's tail."""
    _, planted, _, _, out, conf, rounds, drawn = _capped(True, z=0)
    assert rounds == [18] and drawn == 18 and conf == [1]
    assert np.array_equal(out, planted)


def test_tailcut_first_free_pass_keeps_a_vertex_with_no_free_colour():
    from mcmc_colorer_tpu_torch.models import mcmc_resident as mr
    from mcmc_colorer_tpu_torch.ops.hashgen import er_packed_on_device

    n, p, seed, n_pad = 400, 0.05, 3, 512
    _, _, planted, _, _ = planted_conflict(n, p, seed, n_pad)
    adj = er_packed_on_device(n, p, seed, n_pad, row_chunk=256, device="cpu")
    node_mask = torch.arange(n_pad) < n
    t = torch.from_numpy(planted)[None].clamp(max=0)  # one colour: every edge conflicts
    conf0 = mr.conflicts_from_packed(adj, t, 1, node_mask).numpy()
    out, conf = mr._finish_first_free(adj, t, conf0, node_mask, n_colors=1)
    assert torch.equal(out, t) and conf[0] == conf0[0] > 0
