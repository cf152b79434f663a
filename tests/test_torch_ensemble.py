"""The port's ensemble (``parallel/chains.py``, the chain core of ``models/mcmc.py``)
and the chain axis of K1, K2 and K3, on the CPU.

- Against JAX's ``EnsembleMCMCColorer`` on every path: the generic loop
  (backend ``xla``, and Hastings), the do-while over K2 (``pallas``, flat
  and bucketed, JAX's layout then at the port's class widths) and over K1
  (``matmul``, and Hastings): every chain is fed
  JAX's own draws for that chain (``for_chain(root, c)``: the initial
  colouring, each body's ``k_u`` and ``k_acc``, each tailcut round's
  ``randint``), replayed through ``utils/rng.ChainSources``.  Per-chain iterations, conflicts and
  class-size std, the best chain and its colours must equal JAX's
  (exact).
- Each batched plain kernel (K1, K2, K3) against C single calls: exact.
- Chain c of the port's ensemble equals ``MCMCColorer.run`` fed chain c's
  source, on every backend and both layouts (exact), and a finished
  chain's generator does not advance.
- Mirrors of ``tests/test_parallel.py:28``, ``tests/test_chain_api.py:151``
  and ``tests/test_segmented.py:309``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.config import MCMCParams as JParams
from mcmc_colorer_tpu.config import ProposalKind as JKind
from mcmc_colorer_tpu.parallel.chains import EnsembleMCMCColorer as JEnsemble
from mcmc_colorer_tpu.utils import rng as rngu

from mcmc_colorer_tpu_torch import interop
from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.models.base import check_coloring
from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer, _p_eff_of
from mcmc_colorer_tpu_torch.ops import firstfit as k3
from mcmc_colorer_tpu_torch.ops import packed_nc as k1
from mcmc_colorer_tpu_torch.ops import resample as k2
from mcmc_colorer_tpu_torch.ops.hashgen import er_packed_on_device
from mcmc_colorer_tpu_torch.parallel.chains import EnsembleMCMCColorer
from mcmc_colorer_tpu_torch.utils.rng import ChainSources, TorchUniformSource

from test_torch_active import Replay
from test_torch_mcmc import jax_uniform, port_params

torch.set_num_threads(2)


def jax_chain_draws(seed, chain, n_pad, n_colors, bodies, hastings, tc_rounds=64, split=3):
    """Chain ``chain``'s draws in the order the port's loops take them: the
    initial colouring, ``bodies`` bodies (each splitting its key ``split``
    ways: 3 in the generic loop and under Hastings, 2 in the do-while),
    then tailcut rounds."""
    key = rngu.for_chain(rngu.for_repetition(rngu.root_key(seed), 0), jnp.uint32(chain))
    key, k_init = jax.random.split(key)
    draws = [jax_uniform(k_init, (n_pad,))]
    for _ in range(bodies):
        key, k_u, *k_acc = jax.random.split(key, split)
        draws.append(jax_uniform(k_u, (n_pad,)))
        if hastings:
            draws.append(jax_uniform(k_acc[0], ()))
    k_tc = jax.random.split(key)[1]
    for r in range(tc_rounds):
        draws.append(np.array(jax.random.randint(jax.random.fold_in(k_tc, r), (n_pad,), 0,
                                                 n_colors, dtype=jnp.int32)))
    return draws


# (JAX params, backend, layout): the generic loop (xla, and Hastings, which
# takes the generic loop on the ELL), the do-while over K2 (pallas: JAX's
# kernel in interpret mode, the port's plain K2) on both layouts, and the
# packed do-while over K1 (matmul), also with Hastings
ENSEMBLES = {
    "balance": (dict(proposal=JKind.BALANCE_DYNAMIC, taboo_iterations=1), "xla", "flat"),
    "standard": (dict(proposal=JKind.STANDARD), "xla", "flat"),
    "hastings": (dict(proposal=JKind.BALANCE_DYNAMIC, hastings=True, lambda_=25.0,
                      max_iterations=30), "xla", "flat"),
    "pallas": (dict(proposal=JKind.BALANCE_DYNAMIC, taboo_iterations=1), "pallas", "flat"),
    "pallas_bucketed": (dict(proposal=JKind.BALANCE_DYNAMIC), "pallas", "bucketed"),
    "matmul": (dict(proposal=JKind.BALANCE_DYNAMIC, taboo_iterations=1), "matmul", "flat"),
    "matmul_hastings": (dict(proposal=JKind.BALANCE_DYNAMIC, hastings=True, lambda_=25.0,
                             max_iterations=30), "matmul", "flat"),
}


def do_while_bodies(iterations, max_iterations):
    """Bodies a do-while chain ran: one more than its iterations (the body
    that found it done) unless it stopped at the cap."""
    return iterations + (iterations < max_iterations)


def _port_classes(monkeypatch):
    """JAX's bucketed layout at the port's class widths, 8 · 4^k under
    every backend (JAX's ``pallas`` takes 128 · 4^k, its TPU lane)."""
    from mcmc_colorer_tpu.graph.container import Graph as JGraph

    jax_bucketed = JGraph.to_ell_bucketed
    monkeypatch.setattr(JGraph, "to_ell_bucketed",
                        lambda self, **kw: jax_bucketed(self, **{**kw, "min_lane": 8}))


@pytest.mark.parametrize("case", list(ENSEMBLES))
def test_ensemble_matches_jax_on_its_draws(medium_er, case, monkeypatch):
    kw, backend, layout = ENSEMBLES[case]
    jp = JParams(n_colors=max(4, medium_er.max_degree // 2), tailcut=True, **kw)
    n_chains, seed = 3, 21
    if layout == "bucketed":
        _port_classes(monkeypatch)
    ja = JEnsemble(medium_er, jp, n_chains=n_chains, backend=backend, layout=layout)
    want_best, want = ja.run(seed=seed)
    ens = EnsembleMCMCColorer(interop.graph_from_jax(medium_er), port_params(jp), n_chains,
                              backend=backend, layout=layout, device="cpu")
    assert ens.ell.n_pad == ja.ell.n_pad
    fused = ja._fused_carry
    assert fused == (backend != "xla" and not (backend == "pallas" and jp.hastings))
    sources = ChainSources([
        Replay(jax_chain_draws(
            seed, c, ens.ell.n_pad, jp.n_colors,
            do_while_bodies(want[c]["iterations"], jp.max_iterations) if fused
            else want[c]["iterations"],
            jp.hastings, split=3 if jp.hastings or not fused else 2))
        for c in range(n_chains)
    ], "cpu")
    best, got = ens.run(seed=seed, sources=sources)
    assert got == want
    assert best.extra["best_chain"] == want_best.extra["best_chain"]
    assert np.array_equal(best.colors, want_best.colors)
    assert best.iterations == want_best.iterations
    assert np.array_equal(best.conflict_trace, np.asarray(want_best.conflict_trace))
    assert {k: best.extra[k] for k in want_best.extra} == want_best.extra


@pytest.mark.parametrize("chains", [2, 4])
def test_batched_plain_kernels_equal_single_calls(medium_er, chains):
    """K2, K3 and K1's plain versions with a chain axis against one call a
    chain: every output exact."""
    g = interop.graph_from_jax(medium_er)
    ell = g.to_ell(pad_nodes_to=128, device="cpu")
    n_colors = medium_er.max_degree // 2
    gen = torch.Generator().manual_seed(chains)
    cols = torch.randint(0, n_colors, (chains, ell.n_pad), generator=gen, dtype=torch.int32)
    cols[:, g.n:] = n_colors
    rows = g.n
    cur = cols[:, :rows].contiguous()
    taboo = torch.randint(0, 3, (chains, rows), generator=gen, dtype=torch.int32)
    unif = torch.rand((chains, rows), generator=gen)
    for kind in (ProposalKind.BALANCE_DYNAMIC, ProposalKind.STANDARD, ProposalKind.DECREASE_EXP):
        p = MCMCParams(n_colors=n_colors, proposal=kind, taboo_iterations=2, epsilon=1e-3)
        pe = _p_eff_of(cols[0], p, g.n, ell.node_mask)
        pe = None if pe is None else torch.stack(
            [_p_eff_of(cols[c], p, g.n, ell.node_mask) for c in range(chains)])
        lookup = cols[:, :g.n].contiguous()
        out = k2.resample_sweep_plain(ell.neighbors[:rows], lookup, cur, taboo, 0, unif, pe,
                                      1e-3, p)
        assert out[3].shape == (chains,)
        for c in range(chains):
            one = k2.resample_sweep_plain(ell.neighbors[:rows], lookup[c], cur[c], taboo[c], 0,
                                          unif[c], None if pe is None else pe[c], 1e-3, p)
            for a, b in zip(out[:3], one[:3]):
                assert torch.equal(a[c], b)
            assert int(out[3][c]) == int(one[3])
    allow = (torch.arange(n_colors) % 5 != 3).to(torch.int32)
    for own in (None, cols):
        ff = k3.first_fit(ell.neighbors, cols, allow, n_colors, own)
        for c in range(chains):
            one = k3.first_fit(ell.neighbors, cols[c], allow, n_colors,
                               None if own is None else own[c])
            assert torch.equal(ff[c], one)
    adj = er_packed_on_device(medium_er.n, 0.05, 2, 512, row_chunk=128, device="cpu")
    nc = torch.randint(-1, n_colors + 2, (chains, 512), generator=gen, dtype=torch.int32)
    counts = k1.packed_nc(adj, nc, 128)
    assert counts.shape == (chains, 512, 128)
    for c in range(chains):
        assert torch.equal(counts[c], k1.packed_nc(adj, nc[c], 128))


def test_batched_kernels_check_shapes():
    ids = torch.zeros((4, 8), dtype=torch.int32)
    cols = torch.zeros((2, 16), dtype=torch.int32)
    p = MCMCParams(n_colors=5)
    with pytest.raises(TypeError, match="chain axis"):
        k2.resample_sweep(ids, cols, torch.zeros(4, dtype=torch.int32),
                          torch.zeros(4, dtype=torch.int32), 0, torch.zeros(4), None, 0.0, p)
    with pytest.raises(TypeError, match="p_eff"):
        k2.resample_sweep(ids, cols, torch.zeros((2, 4), dtype=torch.int32),
                          torch.zeros((2, 4), dtype=torch.int32), 0, torch.zeros((2, 4)),
                          torch.zeros(5), 0.0, p)
    with pytest.raises(TypeError, match="cur"):
        k3.first_fit(ids, cols, torch.ones(5, dtype=torch.int32), 5,
                     torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        k3.first_fit_cuda(ids, cols, torch.ones(5, dtype=torch.int32), 5)


@pytest.mark.parametrize("backend, layout", [
    ("pallas", "flat"), ("xla", "flat"), ("matmul", "flat"), ("pallas", "bucketed"),
    ("xla", "bucketed"),
])
def test_chain_equals_one_chain_run(medium_er, backend, layout):
    """Chain c of the ensemble ends where ``MCMCColorer.run`` fed chain c's
    source ends: iterations, conflicts and colours (the best chain's)."""
    g = interop.graph_from_jax(medium_er)
    p = MCMCParams(n_colors=max(4, medium_er.max_degree // 2),
                   proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    best, summaries = EnsembleMCMCColorer(g, p, 3, backend=backend, layout=layout,
                                          device="cpu").run(seed=11)
    one = MCMCColorer(g, p, backend=backend, layout=layout, device="cpu")
    for c in range(3):
        r = one.run(11, source=TorchUniformSource(11, 0, "cpu", chain=c))
        assert (r.iterations, r.extra["final_conflicts"]) == (
            summaries[c]["iterations"], summaries[c]["conflicts"])
        assert r.histogram.std() == summaries[c]["class_std"]
        if c == best.extra["best_chain"]:
            assert np.array_equal(r.colors, best.colors)
            assert r.extra["tailcut_rounds"] == best.extra["tailcut_rounds"]
    assert len({s["iterations"] for s in summaries} | {s["class_std"] for s in summaries}) > 2
    assert check_coloring(g, best.colors)


def test_finished_chain_does_not_draw(medium_er):
    """A chain that finished first keeps its generator where it was: after
    the ensemble each chain's source is where a run of it alone leaves it,
    and ``ChainSources`` leaves the sources of chains not running as they
    were."""
    g = interop.graph_from_jax(medium_er)
    # a palette of a third of the max degree: the chains need 5-7 sweeps
    p = MCMCParams(n_colors=max(4, medium_er.max_degree // 3), tailcut=True,
                   taboo_iterations=1)
    sources = ChainSources.seeded(11, 0, 3, "cpu")
    _, summaries = EnsembleMCMCColorer(g, p, 3, device="cpu").run(seed=11, sources=sources)
    assert len({s["iterations"] for s in summaries}) > 1  # the chains finish apart
    one = MCMCColorer(g, p, device="cpu")
    for c in range(3):
        alone = TorchUniformSource(11, 0, "cpu", chain=c)
        one.run(11, source=alone)
        assert torch.equal(sources.sources[c].get_state(), alone.get_state())
    before = sources.get_state()
    u = sources.next(5, running=np.array([False, True, False]))
    after = sources.get_state()
    assert torch.equal(before[0], after[0]) and torch.equal(before[2], after[2])
    assert not torch.equal(before[1], after[1])
    assert not u[0].any() and not u[2].any() and u[1].all()


def test_chain_streams(medium_er):
    """Chain c's stream depends on (seed, repetition, c) only, never on the
    chain count, and differs from the other chains' and the chainless one."""
    a = ChainSources.seeded(5, 1, 2, "cpu").next(6)
    b = ChainSources.seeded(5, 1, 4, "cpu").next(6)
    assert torch.equal(a, b[:2])
    assert len({tuple(x.tolist()) for x in b}) == 4
    assert not torch.equal(TorchUniformSource(5, 1, "cpu").next(6), b[0])
    assert not torch.equal(ChainSources.seeded(6, 1, 1, "cpu").next(6)[0], b[0])


def test_ensemble_local(small_er):
    """Mirrors tests/test_parallel.py:test_ensemble_local."""
    best, summaries = EnsembleMCMCColorer(
        interop.graph_from_jax(small_er), MCMCParams(n_colors=small_er.max_degree), 4,
        device="cpu").run(seed=13)
    assert len(summaries) == 4 and [s["chain"] for s in summaries] == [0, 1, 2, 3]
    assert best.extra["final_conflicts"] == 0 and best.extra["n_chains"] == 4
    assert check_coloring(interop.graph_from_jax(small_er), best.colors)
    assert best.extra["final_conflicts"] <= min(s["conflicts"] for s in summaries)


def test_ensemble_bucketed_and_refusals(medium_er):
    """Mirrors tests/test_chain_api.py:test_ensemble_bucketed; ``matmul``
    refuses the bucketed layout, as in JAX."""
    g = interop.graph_from_jax(medium_er)
    p = MCMCParams(n_colors=medium_er.max_degree, tailcut=True)
    best, summaries = EnsembleMCMCColorer(g, p, 3, layout="bucketed", device="cpu").run(seed=4)
    assert len(summaries) == 3 and best.extra["final_conflicts"] == 0
    assert check_coloring(g, best.colors)
    with pytest.raises(ValueError, match="flat-layout only"):
        EnsembleMCMCColorer(g, p, 2, backend="matmul", layout="bucketed", device="cpu")
    with pytest.raises(ValueError, match="n_chains"):
        EnsembleMCMCColorer(g, p, 0, device="cpu")
