"""The port's sequential host colorers against the JAX package's.

``greedy_seq`` and ``mcmc_sequential`` are numpy on the host in both
packages and draw from ``np.random.default_rng(seed + repetition)``, so
for the same graph, parameters, seed and repetition the colours and
every reported number must be equal.
"""

import numpy as np
import pytest

from mcmc_colorer_tpu.config import MCMCParams as JParams
from mcmc_colorer_tpu.models.greedy_seq import SequentialGreedyColorer as JGreedySeq
from mcmc_colorer_tpu.models.mcmc_sequential import SequentialMCMCColorer as JSeqMCMC

from mcmc_colorer_tpu_torch.config import MCMCParams
from mcmc_colorer_tpu_torch.interop import graph_from_jax
from mcmc_colorer_tpu_torch.models.base import check_coloring
from mcmc_colorer_tpu_torch.models.greedy_seq import SequentialGreedyColorer
from mcmc_colorer_tpu_torch.models.mcmc_sequential import SequentialMCMCColorer


@pytest.mark.parametrize("fixture", ["small_er", "medium_er"])
def test_greedy_seq_matches_jax(request, fixture):
    jg = request.getfixturevalue(fixture)
    g = graph_from_jax(jg)
    want = JGreedySeq(jg).run()
    got = SequentialGreedyColorer(g).run()
    assert got.colors.dtype == np.int32
    assert np.array_equal(got.colors, want.colors)
    assert (got.n_colors, got.iterations) == (want.n_colors, want.iterations)
    assert check_coloring(g, got.colors)


CASES = {
    "default": dict(),
    "tailcut_tight": dict(tailcut=True, ratio=2.0),
    "taboo": dict(taboo_iterations=2, max_iterations=40),
    "hastings": dict(hastings=True, lambda_=5.0, max_iterations=20),
    "stall_escape": dict(tailcut=True, seq_stall_escape=True, ratio=3.0, max_iterations=10),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("repetition", [0, 2])
def test_mcmc_sequential_matches_jax(small_er, case, repetition):
    kw = dict(CASES[case])
    ratio = kw.pop("ratio", 1.0)
    n_col = max(2, int(small_er.max_degree / ratio))
    jp = JParams(n_colors=n_col, **kw)
    tp = MCMCParams(n_colors=n_col, **kw)
    want = JSeqMCMC(small_er, jp).run(seed=7, repetition=repetition)
    got = SequentialMCMCColorer(graph_from_jax(small_er), tp).run(seed=7, repetition=repetition)
    assert np.array_equal(got.colors, want.colors)
    assert (got.n_colors, got.iterations, got.converged) == (
        want.n_colors, want.iterations, want.converged)
    assert np.array_equal(got.conflict_trace, want.conflict_trace)
    for k, v in want.extra.items():
        assert np.array_equal(np.asarray(got.extra[k]), np.asarray(v)), k
