"""The resident colorer's ensemble, checkpoints and free-colour TRACE, and
the flat chain's TRACE, against the JAX package's, on the CPU.

- Teacher-forced ensemble: JAX's vmapped ``_chain_segment_matmul``
  (``_jit_segment_v``) is stepped one body at a time; from each batched
  JAX carry (``interop.chains_from_numpy``) the port runs one batched body
  (one K1 launch with a chain axis; its plain version here) on the
  uniforms each chain drew from its own key (``for_chain(root, c)``).
  Iterations, exit flags, conflict counts and traces must be equal;
  colours follow the CDF-boundary rule of ``test_torch_sweep.py`` (at most
  0.1 % of vertices, each within 1e-5 of a cdf step); taboo is equal where
  the colours agree.  A chain that is done draws nothing.
- Checkpoints (the port's own chain): resuming reproduces the
  uninterrupted run bit for bit, one chain and the ensemble; the graph
  spec and the palette are checked; a JAX checkpoint is refused.
- Chain c of the resident ensemble equals a one-chain run fed chain c's
  source (exact).
- TRACE: the (min, max, avg) free colours equal JAX's ``_free_nc``
  (resident) and ``_free_color_stats`` (flat ELL) on the same colours:
  min and max exact, avg to 1e-6 relative.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.config import MCMCParams as JParams
from mcmc_colorer_tpu.config import ProposalKind as JKind
from mcmc_colorer_tpu.graph.generate import erdos_renyi
from mcmc_colorer_tpu.models import mcmc as jm
from mcmc_colorer_tpu.models.mcmc_resident import ResidentMCMCColorer as JResident
from mcmc_colorer_tpu.utils import rng as rngu

from mcmc_colorer_tpu_torch import interop
from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.models import mcmc as tm
from mcmc_colorer_tpu_torch.models.base import check_coloring
from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer
from mcmc_colorer_tpu_torch.utils.rng import ChainSources, TorchUniformSource

from test_torch_resident import Replay, jax_cdf, jax_uniform
from test_torch_sweep import assert_boundary_only

torch.set_num_threads(2)

N, P, GRAPH_SEED, CHAINS = 1200, 0.04, 21, 3


def resident(**kw):
    return ResidentMCMCColorer(N, P, GRAPH_SEED, device="cpu", **kw)


@pytest.mark.parametrize("case", ["default", "hastings"])
def test_teacher_forced_ensemble(case):
    c0 = JResident(N, P, graph_seed=GRAPH_SEED)
    kw = dict(hastings=True, lambda_=25.0, max_iterations=3) if case == "hastings" else {}
    jp = JParams(n_colors=max(4, c0.max_degree // 2), proposal=JKind.BALANCE_DYNAMIC,
                 tailcut=True, **kw)
    c = JResident(N, P, graph_seed=GRAPH_SEED, params=jp, n_chains=CHAINS)
    pt = MCMCParams(n_colors=jp.n_colors, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True,
                    max_iterations=jp.max_iterations, hastings=jp.hastings, lambda_=jp.lambda_)
    adj = interop.adjacency_from_jax(np.asarray(c.adj))
    n_pad = adj.shape[0]
    block = tm.choose_block_size(N, pt.n_colors)
    root = rngu.for_repetition(rngu.root_key(7), 0)
    keys = jax.vmap(lambda k: rngu.for_chain(root, k))(jnp.arange(CHAINS, dtype=jnp.uint32))
    carry = c._jit_init_v(c.ell, keys)
    fields = (0, 1, 3, 4, 5, 6)
    bodies = 0
    while True:
        state = interop.chains_from_numpy(*(np.asarray(carry[i]) for i in fields))
        running = tm._running(state, np.full(CHAINS, jp.max_iterations), params=pt,
                                    n_nodes=N, fused=True)
        if not running.any():
            break
        draws = []
        for k in range(CHAINS):
            if not running[k]:
                draws.append(Replay([]))  # a done chain draws nothing
                continue
            if jp.hastings:
                _, k_u, k_acc = jax.random.split(carry[2][k], 3)
                extra = [np.array([jax.random.uniform(k_acc, (), dtype=jnp.float32)])]
            else:
                _, k_u = jax.random.split(carry[2][k])
                extra = []
            draws.append(Replay([jax_uniform(k_u, n_pad)] + extra))
        unif = [d.draws[0] if d.draws else None for d in draws]
        cdfs = [jax_cdf(c, (carry[0][k],)) for k in range(CHAINS)]
        got = tm._chain_body(adj, state, running, params=pt, block=block, n_nodes=N,
                              sources=ChainSources(draws, "cpu"), sweep=tm._sweep_matmul)
        assert all(not d.draws for d in draws)
        carry = c._jit_segment_v(c.ell, c.adj, carry, jnp.int32(1))
        want = interop.chains_from_numpy(*(np.asarray(carry[i]) for i in fields))
        assert np.array_equal(got.rip, want.rip) and np.array_equal(got.done, want.done)
        assert np.array_equal(got.conf_last, want.conf_last)
        assert np.array_equal(got.trace, want.trace)
        for k in range(CHAINS):
            if not running[k]:
                assert torch.equal(got.colors[k], state.colors[k])
                continue
            mism = assert_boundary_only(got.colors[k].numpy(), want.colors[k].numpy(),
                                        unif[k], cdfs[k], N)
            keep = np.ones(n_pad, bool)
            keep[mism] = False
            assert np.array_equal(got.taboo[k].numpy()[keep], want.taboo[k].numpy()[keep])
        back = interop.chains_to_numpy(want)
        assert np.array_equal(back["trace"], np.asarray(carry[5]))
        bodies += 1
    assert bodies >= 2


def test_resident_ensemble_matches_jax_on_its_draws():
    """JAX's resident ``run_ensemble`` against the port's, each chain fed
    JAX's own draws for it (``for_chain(root, c)``: the initial colouring,
    each do-while body's ``k_u``, each NC tailcut round's coins): per-chain
    iterations, conflicts and class-size std, the best chain, its colours
    and trace, and the tailcut's rounds, exact."""
    c0 = JResident(N, P, graph_seed=GRAPH_SEED)
    jp = JParams(n_colors=max(4, c0.max_degree // 2), proposal=JKind.BALANCE_DYNAMIC,
                 tailcut=True)
    j = JResident(N, P, graph_seed=GRAPH_SEED, params=jp, n_chains=CHAINS)
    want_best, want = j.run_ensemble(seed=7)
    pt = MCMCParams(n_colors=jp.n_colors, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    port = resident(params=pt, n_chains=CHAINS)
    n_pad = port.n_pad
    assert n_pad == j.adj.shape[0]
    root = rngu.for_repetition(rngu.root_key(7), 0)
    replays = []
    for c in range(CHAINS):
        key = rngu.for_chain(root, jnp.uint32(c))
        key, k_init = jax.random.split(key)
        draws = [jax_uniform(k_init, n_pad)]
        rip = want[c]["iterations"]
        for _ in range(rip + (rip < jp.max_iterations)):  # the do-while's bodies
            key, k_u = jax.random.split(key)
            draws.append(jax_uniform(k_u, n_pad))
        for _ in range(want_best.extra["tailcut_rounds"]):
            key, k_r = jax.random.split(key)
            draws.append(jax_uniform(k_r, n_pad))
        replays.append(Replay(draws))
    best, got = port.run_ensemble(seed=7, sources=ChainSources(replays, "cpu"))
    assert got == want
    assert want_best.extra["tailcut_rounds"] > 0
    assert np.array_equal(best.colors, want_best.colors)
    assert np.array_equal(best.conflict_trace, np.asarray(want_best.conflict_trace))
    assert {k: best.extra[k] for k in want_best.extra if k != "gen_seconds"} == {
        k: v for k, v in want_best.extra.items() if k != "gen_seconds"}


def test_checkpoint_resume_bit_equal(tmp_path):
    """Mirrors tests/test_resident.py:test_resident_checkpoint_resume_bit_equal."""
    c0 = resident()
    p_full = MCMCParams(n_colors=max(4, c0.max_degree * 2 // 3),
                        proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True, max_iterations=60)
    full = resident(params=p_full).run(seed=5)
    ck = str(tmp_path / "resident.npz")
    pre = resident(params=p_full.replace(max_iterations=2)).run(seed=5, checkpoint_path=ck)
    assert pre.iterations == 2
    resumed = resident(params=p_full).run(seed=5, resume_from=ck)
    assert resumed.iterations == full.iterations > 2
    assert np.array_equal(resumed.colors, full.colors)
    assert resumed.extra["final_conflicts"] == full.extra["final_conflicts"]
    assert resumed.extra["tailcut_rounds"] == full.extra["tailcut_rounds"]
    assert np.array_equal(resumed.conflict_trace, full.conflict_trace)
    assert not list(tmp_path.glob("*.tmp.npz"))


def test_checkpoint_mismatch_and_jax_refusal(tmp_path):
    """Mirrors test_resident_checkpoint_spec_mismatch; a palette mismatch
    and a JAX checkpoint are refused too."""
    c = ResidentMCMCColorer(600, 0.05, 9, device="cpu")
    ck = str(tmp_path / "a.npz")
    c.run(seed=1, checkpoint_path=ck)
    with pytest.raises(AssertionError, match="graph spec mismatch"):
        ResidentMCMCColorer(600, 0.05, 10, device="cpu").run(seed=1, resume_from=ck)
    with pytest.raises(AssertionError, match="palette mismatch"):
        ResidentMCMCColorer(600, 0.05, 9, params=c.params.replace(n_colors=7),
                            device="cpu").run(seed=1, resume_from=ck)
    j = JResident(600, 0.05, graph_seed=9)
    jk = str(tmp_path / "jax.npz")
    j.save_checkpoint(j._jit_init(j.ell, jax.random.key(1)), jk)
    with pytest.raises(ValueError, match="JAX package"):
        c.run(seed=1, resume_from=jk)


def test_ensemble_best_of_chains():
    """Mirrors tests/test_resident.py:test_resident_ensemble_best_of_chains."""
    c = ResidentMCMCColorer(800, 0.04, 31, n_chains=4, device="cpu")
    best, summaries = c.run_ensemble(seed=9)
    assert len(summaries) == 4 and best.extra["chains"] == 4
    assert best.extra["best_chain"] == summaries[best.extra["best_chain"]]["chain"]
    assert best.extra["final_conflicts"] == 0
    assert check_coloring(c.host_graph(), best.colors)
    assert np.array_equal(c.run(seed=9).colors, best.colors)
    assert c.last_summaries == summaries
    assert len({s["class_std"] for s in summaries}) > 1


def test_ensemble_chain_equals_one_chain_run():
    """Chain c of the resident ensemble ends where a one-chain resident run
    fed chain c's source ends (its NC tailcut included)."""
    c0 = resident()
    p = MCMCParams(n_colors=max(4, c0.max_degree // 2), proposal=ProposalKind.BALANCE_DYNAMIC,
                   tailcut=True)
    best, summaries = resident(params=p, n_chains=CHAINS).run_ensemble(seed=4)
    one = resident(params=p)
    rounds = 0
    for k in range(CHAINS):
        r = one.run(4, source=TorchUniformSource(4, 0, "cpu", chain=k))
        assert (r.iterations, r.extra["final_conflicts"]) == (
            summaries[k]["iterations"], summaries[k]["conflicts"])
        rounds = max(rounds, r.extra["tailcut_rounds"])
        if k == best.extra["best_chain"]:
            assert np.array_equal(r.colors, best.colors)
            assert np.array_equal(r.conflict_trace, best.conflict_trace)
    assert best.extra["tailcut_rounds"] == rounds > 0


def test_ensemble_checkpoint_resume(tmp_path):
    """Mirrors test_resident_ensemble_checkpoint_resume, every chain."""
    ck = str(tmp_path / "ens.npz")
    c0 = ResidentMCMCColorer(800, 0.04, 31, n_chains=4, device="cpu")
    full, full_s = c0.run_ensemble(seed=9)
    pre = ResidentMCMCColorer(800, 0.04, 31, n_chains=4, device="cpu",
                              params=c0.params.replace(max_iterations=1))
    pre.run_ensemble(seed=9, checkpoint_path=ck)
    resumed, summ = ResidentMCMCColorer(800, 0.04, 31, n_chains=4, params=c0.params,
                                        device="cpu").run_ensemble(seed=9, resume_from=ck)
    assert np.array_equal(resumed.colors, full.colors)
    assert summ == full_s
    with pytest.raises(AssertionError, match="chain count"):
        ResidentMCMCColorer(800, 0.04, 31, n_chains=2, params=c0.params,
                            device="cpu").run_ensemble(seed=9, resume_from=ck)


def test_resident_free_color_trace_matches_jax(monkeypatch, capsys):
    """Mirrors test_resident_free_color_trace; the stats equal JAX's
    ``_free_nc`` on the same colours."""
    monkeypatch.setenv("MCMC_COLORER_TRACE", "1")
    j = JResident(800, 0.04, graph_seed=31)
    j.run(seed=3)  # builds JAX's _jit_free_nc
    c = ResidentMCMCColorer(800, 0.04, 31, device="cpu")
    r = c.run(seed=3)
    segs = r.extra["free_color_trace_segments"]
    assert segs
    for mn, mx, avg in segs:
        assert 0 <= mn <= avg <= mx <= c.params.n_colors
    rng = np.random.default_rng(2)
    for n_colors in (c.params.n_colors, 9):
        colors = rng.integers(0, n_colors, c.n_pad).astype(np.int32)
        colors[c.n:] = n_colors
        c.params = c.params.replace(n_colors=n_colors)
        j.params = j.params.replace(n_colors=n_colors)
        del j._jit_free_nc
        j.run(seed=3)
        want = [float(x) for x in j._jit_free_nc(j.adj, jnp.asarray(colors))]
        got = c.free_color_stats(torch.from_numpy(colors))
        assert got[:2] == tuple(int(x) for x in want[:2])
        assert got[2] == pytest.approx(want[2], rel=1e-6)
    out = capsys.readouterr()
    assert re.search(r"Max Free Colors: \d+ - Min Free Colors: \d+ - AVG Free Colors: [\d.]+",
                     out.out + out.err)


@pytest.mark.parametrize("n_colors", [None, 6])
def test_flat_free_color_stats_match_jax(medium_er, n_colors):
    n_colors = n_colors or medium_er.max_degree
    je = medium_er.to_ell(pad_nodes_to=128)
    te = interop.graph_from_jax(medium_er).to_ell(pad_nodes_to=128, device="cpu")
    colors = np.random.default_rng(4).integers(0, n_colors, je.n_pad).astype(np.int32)
    colors[medium_er.n:] = n_colors
    want = [float(x) for x in jm._free_color_stats(je, jnp.asarray(colors), n_colors=n_colors,
                                                    block=128)]
    got = tm._free_color_stats(te, torch.from_numpy(colors), n_colors=n_colors)
    assert got[:2] == tuple(int(x) for x in want[:2])
    assert got[2] == pytest.approx(want[2], rel=1e-6)


def test_device_chain_free_color_trace(monkeypatch, capsys):
    """Mirrors tests/test_stall_escape.py:test_device_chain_free_color_trace:
    under TRACE every segment of the flat chain reports the free colours of
    the current colouring in the reference's line format, and the run's
    colouring is the untraced run's."""
    g = interop.graph_from_jax(erdos_renyi(256, 0.05, seed=5))
    p = MCMCParams(n_colors=max(2, g.max_degree), proposal=ProposalKind.STANDARD)
    plain = tm.MCMCColorer(g, p, device="cpu").run(seed=1)
    monkeypatch.setenv("MCMC_COLORER_TRACE", "1")
    r = tm.MCMCColorer(g, p, device="cpu").run(seed=1)
    assert np.array_equal(r.colors, plain.colors)
    segs = r.extra["free_color_trace_segments"]
    assert segs
    for mn, mx, avg in segs:
        assert 0 <= mn <= avg <= mx <= p.n_colors
    out = capsys.readouterr()
    assert len(re.findall(r"Max Free Colors: \d+ - Min Free Colors: \d+ - "
                          r"AVG Free Colors: [\d.]+", out.out + out.err)) == len(segs)
    # the bucketed layout prints none, as in JAX
    rb = tm.MCMCColorer(g, p, layout="bucketed", device="cpu").run(seed=1)
    assert "free_color_trace_segments" not in rb.extra
