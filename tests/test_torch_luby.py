"""The port's Luby colorer against the JAX package's.

Luby draws coin flips, so the port is fed JAX's own uniforms: a source
that splits JAX's key the way JAX's loops do (``key, sub = split(key)``
a round, ``uniform(sub, (n,))``) hands them out through the port's
``next(n)`` (the order of ``utils/rng.py``; the replay model is
``tests/test_torch_resident.py:Replay``).  Every decision is an integer
or a ``u < 0.5`` comparison, so the colourings and colour counts must be
bit-equal (``np.array_equal`` on int32 colours):

- the gather loop and the frontier loop against JAX's ``run``;
- resident Luby (K1's plain version on the CPU) against JAX's
  ``_luby_segment_matmul`` on the same hash adjacency, and against the
  port's own gather loop on the host graph of the same hash whose ELL is
  padded to the same ``n_pad`` (the draws have ``n_pad`` entries a
  round, so another padding gives another stream).

The frontier gather that the frontier loops share, ``frontier_ids`` and
``take_rows`` (flat), is held against JAX's ``nonzero`` and
``take_rows``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.models.luby import LubyColorer as JLuby
from mcmc_colorer_tpu.ops.neighbor import take_rows as j_take_rows
from mcmc_colorer_tpu.utils import rng as rngu

from mcmc_colorer_tpu_torch import interop
from mcmc_colorer_tpu_torch.models import luby as tl
from mcmc_colorer_tpu_torch.models.base import check_coloring
from mcmc_colorer_tpu_torch.models.luby import LubyColorer
from mcmc_colorer_tpu_torch.ops import packed_nc as k1
from mcmc_colorer_tpu_torch.ops.neighbor import frontier_ids, take_rows
from mcmc_colorer_tpu_torch.utils.rng import TorchUniformSource

torch.set_num_threads(2)

RES_N, RES_P, RES_SEED = 600, 0.05, 2


class JaxKeySource:
    """JAX's uniforms in JAX's order: one key split a ``next``."""

    def __init__(self, seed: int, repetition: int = 0):
        self.key = rngu.for_repetition(rngu.root_key(seed), repetition)
        self.sizes = []

    def next(self, n):
        self.key, sub = jax.random.split(self.key)
        self.sizes.append(n)
        return torch.from_numpy(np.array(jax.random.uniform(sub, (n,), dtype=jnp.float32)))


def assert_mis_classes(g, colors):
    """Every colour class is a maximal independent set of the vertices
    of that colour or higher (each class peels an MIS of what is left)."""
    assert check_coloring(g, colors)
    assert (colors >= 0).all()
    u = np.repeat(np.arange(g.n), g.degrees)
    for c in range(int(colors.max()) + 1):
        rest = colors >= c
        inside = colors == c
        # a vertex left for later has a neighbour in class c
        hit = np.zeros(g.n, bool)
        np.logical_or.at(hit, u, inside[g.cols])
        assert (hit | ~rest | inside).all(), c


@pytest.mark.parametrize("fixture", ["small_er", "medium_er"])
@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("seed", [1, 5])
def test_luby_matches_jax(request, fixture, active, seed):
    jg = request.getfixturevalue(fixture)
    g = interop.graph_from_jax(jg)
    want = JLuby(jg, active=active).run(seed=seed)
    src = JaxKeySource(seed)
    c = LubyColorer(g, active=active, device="cpu")
    got = c.run(seed=seed, source=src)
    assert got.colors.dtype == np.int32
    assert np.array_equal(got.colors, want.colors)
    assert (got.n_colors, got.iterations) == (want.n_colors, want.iterations)
    assert got.extra["rounds"] == len(src.sizes)
    if active:
        assert set(src.sizes) <= set(range(128, c.ell.n_pad + 1, 128))
    else:
        assert set(src.sizes) == {c.ell.n_pad}


@pytest.mark.parametrize("active", [False, True])
def test_luby_classes_are_maximal(small_er, medium_er, active):
    """The port's own draws (its generator): valid, and every class a
    maximal independent set of the residual graph
    (tests/test_init_colorers.py:112)."""
    for jg in (small_er, medium_er):
        g = interop.graph_from_jax(jg)
        r = LubyColorer(g, active=active, device="cpu").run(seed=9)
        assert r.n_colors <= g.max_degree + 1 and r.colors.max() == r.n_colors - 1
        assert_mis_classes(g, r.colors)
        again = LubyColorer(g, active=active, device="cpu").run(seed=9)
        assert np.array_equal(again.colors, r.colors)


@pytest.mark.parametrize("fixture", ["small_er", "medium_er"])
def test_frontier_ids_and_take_rows(request, fixture):
    """``frontier_ids`` equals ``jnp.nonzero(size=cap, fill_value=n_pad)``
    (ascending, padded, cut at cap) and ``take_rows`` equals JAX's flat
    ``take_rows`` on those ids."""
    jg = request.getfixturevalue(fixture)
    je = jg.to_ell(pad_nodes_to=128)
    te = interop.graph_from_jax(jg).to_ell(pad_nodes_to=128, device="cpu")
    rng = np.random.default_rng(4)
    mask = rng.random(je.n_pad) < 0.3
    for cap in (128, je.n_pad, int(mask.sum()) // 2):
        (jids,) = jnp.nonzero(jnp.asarray(mask), size=cap, fill_value=je.n_pad)
        ids, valid = frontier_ids(torch.from_numpy(mask), cap)
        assert np.array_equal(ids.numpy(), np.asarray(jids))
        assert np.array_equal(valid.numpy(), np.asarray(jids < je.n_pad))
        want = np.asarray(j_take_rows(je, jids, jids < je.n_pad))
        got = take_rows(te, ids, valid)
        assert got.is_contiguous() and np.array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def resident_runs():
    """JAX's resident Luby and the port's, on JAX's draws."""
    want = JLuby(None, resident_spec=(RES_N, RES_P, RES_SEED)).run(seed=3)
    c = LubyColorer(None, resident_spec=(RES_N, RES_P, RES_SEED), device="cpu")
    before = k1.launches
    got = c.run(seed=3, source=JaxKeySource(3))
    assert k1.launches == before  # CPU tensors: K1's plain version
    return c, want, got


def test_resident_luby_matches_jax(resident_runs):
    c, want, got = resident_runs
    assert np.array_equal(got.colors, want.colors)
    assert got.n_colors == want.n_colors
    j = JLuby(None, resident_spec=(RES_N, RES_P, RES_SEED))
    assert np.array_equal(interop.adjacency_to_jax(c.adj), np.asarray(j._adj))
    assert np.array_equal(c.rank_class.numpy(), np.asarray(j._rank_class))
    assert (c.graph.n_edges, c.graph.max_degree) == (j.graph.n_edges, j.graph.max_degree)
    g = c.host_graph()
    assert g.n_edges == c.graph.n_edges
    assert_mis_classes(g, got.colors)


def test_resident_luby_equals_gather_luby(resident_runs):
    """The NC formulation and the gather loop on the host graph of the
    same hash, padded to the same n_pad, with the same draws."""
    c, _, got = resident_runs
    ell = c.host_graph().to_ell(pad_nodes_to=2048, device="cpu")
    assert ell.n_pad == c.n_pad
    colors, n_colors, rounds = tl._run_luby(ell, JaxKeySource(3))
    assert np.array_equal(colors[:RES_N].numpy(), got.colors)
    assert (n_colors, rounds) == (got.n_colors, got.extra["rounds"])


def test_luby_unported_and_device(small_er, monkeypatch):
    g = interop.graph_from_jax(small_er)
    # the matmul loop over a host graph equals the gather loop at its
    # padding (128) on the same draws
    a = LubyColorer(g, backend="matmul", device="cpu")
    b = tl._run_luby(a.ell, TorchUniformSource(4, 0, "cpu"))
    r = a.run(seed=4)
    assert np.array_equal(r.colors, b[0][: g.n].numpy()) and r.n_colors == b[1]
    assert_mis_classes(g, r.colors)
    # a host graph has two backends: values that would change nothing raise
    for backend in ("xla", "pallas"):
        with pytest.raises(ValueError, match="two backends"):
            LubyColorer(g, backend=backend, device="cpu")
    with pytest.raises(ValueError, match="full loop only"):
        LubyColorer(g, backend="matmul", active=True, device="cpu")
    # the bucketed layout runs the gather loop; the matmul loop and
    # resident graphs are flat only, as in JAX
    r = LubyColorer(g, layout="bucketed", device="cpu").run(seed=4)
    assert_mis_classes(g, r.colors)
    with pytest.raises(ValueError, match="full loop only"):
        LubyColorer(g, backend="matmul", layout="bucketed", device="cpu")
    with pytest.raises(ValueError, match="flat full matmul loop"):
        LubyColorer(None, layout="bucketed", resident_spec=(100, 0.1, 1), device="cpu")
    with pytest.raises(ValueError, match="full matmul loop"):
        LubyColorer(None, active=True, resident_spec=(100, 0.1, 1), device="cpu")
    with pytest.raises(ValueError, match="graph=None"):
        LubyColorer(g, resident_spec=(100, 0.1, 1), device="cpu")
    with pytest.raises(ValueError, match="host_graph"):
        LubyColorer(g, device="cpu").host_graph()
    # the default source is the port's generator, seeded per repetition
    a = LubyColorer(g, device="cpu").run(seed=4, repetition=1)
    b = LubyColorer(g, device="cpu").run(seed=4, source=TorchUniformSource(4, 1, "cpu"))
    assert np.array_equal(a.colors, b.colors)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LubyColorer(g)
