"""The benchmark's Barabási–Albert sampler (``reference/ba_edges.py``): a
simple graph, seeded, the (m+1)-clique, m distinct earlier neighbours
for each later vertex, the edge count, a heavy tail, and the degrees of
the program's own sampler of the same model."""

import numpy as np
import pytest

from colorbench.reference import ba_edges

SIZES = [(3000, 8, 0), (517, 3, 2**33 + 1), (10, 9, 4)]


def _degrees(src, dst, n):
    return np.bincount(src, minlength=n) + np.bincount(dst, minlength=n)


@pytest.mark.parametrize("n,m,seed", SIZES)
def test_a_simple_graph_of_the_stated_edge_count(n, m, seed):
    src, dst = ba_edges.ba_edges(n, m, seed)
    assert src.dtype == np.int32 and dst.dtype == np.int32
    assert src.size == m * (m + 1) // 2 + (n - m - 1) * m
    assert (src != dst).all() and (src >= 0).all() and (dst >= 0).all()
    assert (src < n).all() and (dst < n).all()
    lo, hi = np.minimum(src, dst).astype(np.int64), np.maximum(src, dst)
    assert np.unique(lo * n + hi).size == src.size


@pytest.mark.parametrize("n,m,seed", SIZES)
def test_the_clique_then_m_distinct_earlier_vertices_each(n, m, seed):
    src, dst = ba_edges.ba_edges(n, m, seed)
    m0 = m + 1
    head = m0 * (m0 - 1) // 2
    ci, cj = np.triu_indices(m0, k=1)
    assert np.array_equal(src[:head], ci) and np.array_equal(dst[:head], cj)
    new_src, new_dst = src[head:].reshape(-1, m), dst[head:].reshape(-1, m)
    v = np.arange(m0, n)
    assert np.array_equal(new_src, np.repeat(v[:, None], m, axis=1))
    assert (new_dst < v[:, None]).all()
    assert all(np.unique(row).size == m for row in new_dst)


def test_seeded_and_any_whole_seed():
    a = ba_edges.ba_edges(2000, 8, 2**40 + 7)
    b = ba_edges.ba_edges(2000, 8, 2**40 + 7)
    c = ba_edges.ba_edges(2000, 8, 2**40 + 8)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])


def test_a_heavy_tail():
    n, m = 20000, 8
    src, dst = ba_edges.ba_edges(n, m, 5)
    deg = _degrees(src, dst, n)
    assert deg.min() == m and abs(deg.mean() - 2 * m) < 0.01
    assert deg.max() > 20 * deg.mean()


def test_bad_sizes_are_refused():
    for n, m in ((8, 8), (5, 0)):
        with pytest.raises(ValueError):
            ba_edges.ba_edges(n, m, 0)


def test_the_degrees_follow_the_programs_sampler_of_the_model():
    """The same model as the program's Python sampler
    (``graph/generate.barabasi_albert``; another stream): the share of
    vertices at each low degree and the mean log degree agree within a
    few percent over three seeds each."""
    from mcmc_colorer_tpu_torch.graph.generate import barabasi_albert

    n, m = 6000, 8

    def summary(degs):
        d = np.concatenate(degs)
        return np.array([(d == k).mean() for k in (8, 9, 10, 12)] + [np.log(d).mean()])

    ours = summary([_degrees(*ba_edges.ba_edges(n, m, s), n) for s in (1, 2, 3)])
    theirs = summary([barabasi_albert(n, m, seed=s, use_native=False).degrees
                      for s in (1, 2, 3)])
    assert np.allclose(ours, theirs, rtol=0.08), (ours, theirs)
