"""Statistical equivalence of the port's chain: ``MCMCColorer`` on the CPU
must match the port's sequential reference-semantics chain on OUTCOME
metrics across seeds — used colours, iterations to converge, balance
index — as ``tests/test_statistical.py`` requires of the JAX package's,
on the same graph, seeds and thresholds.  The balance index is the
analysis pipeline's (``mcmc_colorer_tpu_torch.analysis.balance_index`` on
each run's histogram), held equal to ``Coloring.balance_index``.
"""

import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.graph.generate import erdos_renyi as jax_erdos_renyi

from mcmc_colorer_tpu_torch.analysis import balance_index
from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.graph.generate import erdos_renyi
from mcmc_colorer_tpu_torch.models.base import check_coloring
from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
from mcmc_colorer_tpu_torch.models.mcmc_sequential import SequentialMCMCColorer

torch.set_num_threads(2)

SEEDS = [3, 17, 41, 59, 83]
P = 0.05


@pytest.fixture(scope="module")
def er300():
    g = erdos_renyi(300, P, seed=123)
    want = jax_erdos_renyi(300, P, seed=123)  # the JAX tests' graph
    assert np.array_equal(g.row_ptr, want.row_ptr) and np.array_equal(g.cols, want.cols)
    return g


def _bi(r, n):
    """The analysis pipeline's balance index of a run, from its histogram
    over the full palette; it must equal the run's own."""
    got = balance_index(r.histogram, n, P, r.n_colors)
    assert abs(got - r.balance_index(P)) < 1e-12
    return got


def _device(g, p):
    return MCMCColorer(g, p, device="cpu")


def _run_many(colorer_factory, g, seeds):
    used, iters, bi = [], [], []
    for s in seeds:
        r = colorer_factory().run(seed=s)
        used.append(r.used_colors)
        iters.append(r.iterations)
        bi.append(_bi(r, g.n))
    return np.array(used), np.array(iters), np.array(bi)


def test_device_chain_matches_sequential_outcomes(er300):
    p = MCMCParams(n_colors=er300.max_degree, proposal=ProposalKind.STANDARD)
    seq_used, seq_iters, seq_bi = _run_many(lambda: SequentialMCMCColorer(er300, p), er300,
                                            SEEDS)
    par_used, par_iters, par_bi = _run_many(lambda: _device(er300, p), er300, SEEDS)
    # both converge within the budget on every seed
    assert (seq_iters <= p.max_iterations).all()
    assert (par_iters <= p.max_iterations).all()
    # used-colour means within 15% of each other
    assert abs(seq_used.mean() - par_used.mean()) <= 0.15 * max(
        seq_used.mean(), par_used.mean()
    )
    # balance-index distributions overlap (means within 2 pooled stds)
    pooled = max(np.std(seq_bi) + np.std(par_bi), 1e-9)
    assert abs(seq_bi.mean() - par_bi.mean()) <= 2.0 * pooled + 1.0


def test_conflict_decay_is_monotonic_in_distribution(er300):
    """Conflict traces must decay: mean conflicts at iteration k+3 below
    iteration k for the early phase, across seeds."""
    p = MCMCParams(
        n_colors=max(4, er300.max_degree // 2),
        proposal=ProposalKind.BALANCE_DYNAMIC,
    )
    traces = []
    for s in SEEDS:
        r = _device(er300, p).run(seed=s)
        t = np.asarray(r.conflict_trace)
        traces.append(t[t >= 0])
    heads = np.array([t[0] for t in traces], dtype=float)
    tails = np.array([t[min(3, len(t) - 1)] for t in traces], dtype=float)
    assert tails.mean() < heads.mean()


def test_balance_dynamic_not_worse_than_standard(er300):
    """Non-inferiority: the balance-dynamic proposal must not degrade the
    balance index against STANDARD (its bias p_c = (1−h_c/n)/(nCol−1) is
    gentle, so on fast-converging graphs the two are statistically
    equal)."""
    n_col = max(4, er300.max_degree // 2)
    bis = {}
    for kind in (ProposalKind.STANDARD, ProposalKind.BALANCE_DYNAMIC):
        p = MCMCParams(n_colors=n_col, proposal=kind, tailcut=True)
        vals = []
        for s in SEEDS:
            r = _device(er300, p).run(seed=s)
            assert check_coloring(er300, r.colors)
            vals.append(_bi(r, er300.n))
        bis[kind] = np.mean(vals)
    assert (
        bis[ProposalKind.BALANCE_DYNAMIC]
        <= bis[ProposalKind.STANDARD] * 1.1 + 0.1
    )


def test_hastings_preserves_validity_and_quality(er300):
    """With acceptance gating on, the chain should still converge (it can
    only reject bad moves) and end in a valid colouring."""
    p = MCMCParams(
        n_colors=er300.max_degree,
        proposal=ProposalKind.STANDARD,
        hastings=True,
        tailcut=True,
    )
    r = _device(er300, p).run(seed=11)
    assert check_coloring(er300, r.colors)
