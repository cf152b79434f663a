"""The packed backend over a host graph (``ops/dense_adj.get_adjacency``,
``MCMCColorer(backend="matmul"|"packed")``, ``LubyColorer(g,
backend="matmul")``) against the JAX package's (``tests/test_matmul_backend.py``,
its packed cases), on the CPU.

- The packed A built on the device from the ELL equals JAX's (host and
  ELL builds, uint32 read as int32 through ``interop``) word for word:
  exact, duplicate edges included.
- One packed sweep against JAX's ``_sweep_matmul`` over its packed A:
  NC and conflicts exact, samples under the CDF-boundary rule of
  ``tests/test_torch_sweep.py``; the packed chain body by body against
  JAX's ``MCMCColorer(backend="packed")`` on JAX's uniforms, Hastings
  included.
- The cache, the simple-graph skip of the completeness check, the
  refusal of multigraphs, Luby's matmul loop on JAX's draws: exact.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.config import MCMCParams as JParams
from mcmc_colorer_tpu.config import ProposalKind as JKind
from mcmc_colorer_tpu.graph.container import Graph as JGraph
from mcmc_colorer_tpu.graph.generate import erdos_renyi as j_er
from mcmc_colorer_tpu.models import mcmc as jm
from mcmc_colorer_tpu.models.luby import LubyColorer as JLuby
from mcmc_colorer_tpu.ops import dense_adj as jd
from mcmc_colorer_tpu.ops.neighbor import color_histogram as j_hist
from mcmc_colorer_tpu.utils import rng as rngu

from mcmc_colorer_tpu_torch import interop
from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.graph.container import Graph
from mcmc_colorer_tpu_torch.models import luby as tl
from mcmc_colorer_tpu_torch.models import mcmc as tm
from mcmc_colorer_tpu_torch.models.base import check_coloring
from mcmc_colorer_tpu_torch.ops import dense_adj as td
from mcmc_colorer_tpu_torch.ops import packed_nc as k1

from test_torch_luby import JaxKeySource, assert_mis_classes
from test_torch_mcmc import (
    RUN1,
    Replay,
    carry_state,
    check_body,
    jax_cdf,
    jax_uniform,
    one,
    port_params,
)
from test_torch_sweep import assert_boundary_only

torch.set_num_threads(2)


def _unpack(packed: np.ndarray, n_cols: int) -> np.ndarray:
    """Decode the packed_bit_coords layout back to a dense 0/1 matrix."""
    word, bit = jd.packed_bit_coords(np.arange(n_cols, dtype=np.int64))
    return ((packed[:, word] >> bit[None, :].astype(np.uint32)) & 1).astype(np.int8)


def _dup_graphs():
    """The 0-1 edge twice in both directions and a 0-2 edge, in both
    packages."""
    rows = np.array([0, 0, 0, 1, 1, 2], np.int64)
    cols = np.array([1, 1, 2, 0, 0, 0], np.int64)
    return (JGraph.from_edges(3, rows, cols, both_directions_present=True),
            Graph.from_edges(3, rows, cols, both_directions_present=True))


def test_packed_adj_build_matches_dense(medium_er):
    """Mirrors test_packed_adj_build_matches_dense: the port's A decodes
    to JAX's dense matrix and equals JAX's packed A word for word."""
    ell = interop.graph_from_jax(medium_er).to_ell(pad_nodes_to=128, device="cpu")
    packed = interop.adjacency_to_jax(td.build_packed_adjacency_from_ell(ell))
    assert packed.shape == (ell.n_pad, td.packed_adj_words(ell.n_pad))
    dense = np.asarray(jd.build_dense_adjacency(medium_er, ell.n_pad))
    assert np.array_equal(_unpack(packed, ell.n_pad), dense)
    assert np.array_equal(packed, np.asarray(jd.build_packed_adjacency(medium_er, ell.n_pad)))


@pytest.mark.parametrize("chunks", ["one", "many"])
def test_ell_builders_match_host_builds(medium_er, monkeypatch, chunks):
    """Mirrors test_ell_builders_match_host_builds, multi-window widths
    included, in one row chunk and in chunks of 8 rows."""
    for jg in (medium_er, j_er(jd.PACKED_K_CHUNK + 640, 0.002, seed=4)):
        ell = interop.graph_from_jax(jg).to_ell(pad_nodes_to=128, device="cpu")
        words = td.packed_adj_words(ell.n_pad)
        if chunks == "many":
            monkeypatch.setattr(td, "PACK_STRIP_BYTES", 8 * words * 32)
        got = interop.adjacency_to_jax(td.build_packed_adjacency_from_ell(ell))
        je = jg.to_ell(pad_nodes_to=128)
        assert np.array_equal(got, np.asarray(jd.build_packed_adjacency(jg, ell.n_pad)))
        assert np.array_equal(got, np.asarray(jd.build_packed_adjacency_from_ell(je)))
        assert td.adjacency_nnz(interop.adjacency_from_jax(got)) == jd.adjacency_nnz(
            jd.build_packed_adjacency(jg, ell.n_pad)) == 2 * jg.n_edges


def test_packed_duplicate_edges():
    """Mirrors test_packed_duplicate_edges and
    test_ell_builder_duplicate_edges: duplicate edges land once."""
    jg, g = _dup_graphs()
    got = interop.adjacency_to_jax(
        td.build_packed_adjacency_from_ell(g.to_ell(pad_nodes_to=8, device="cpu")))
    ref = np.zeros((8, 8), np.int8)
    ref[0, 1] = ref[0, 2] = ref[1, 0] = ref[2, 0] = 1
    assert np.array_equal(_unpack(got, 8), ref)
    assert np.array_equal(got, np.asarray(jd.build_packed_adjacency(jg, 8)))
    assert np.array_equal(got, np.asarray(jd.build_packed_adjacency_from_ell(
        jg.to_ell(pad_nodes_to=8))))


def test_matmul_refuses_duplicate_edges():
    """Mirrors test_matmul_refuses_duplicate_edges."""
    _, g = _dup_graphs()
    ell = g.to_ell(pad_nodes_to=8, device="cpu")
    with pytest.raises(ValueError, match="duplicate edges"):
        td.get_adjacency(g, ell)
    with pytest.raises(ValueError, match="duplicate edges"):
        tm.MCMCColorer(g, MCMCParams(n_colors=2), backend="packed", device="cpu")


def test_get_adjacency_cache(medium_er):
    """Mirrors test_get_adjacency_cache: one build per (graph, n_pad,
    device); a second call at the same n_pad, even with another ELL
    object, takes it; another n_pad builds its own."""
    g = interop.graph_from_jax(medium_er)
    ell = g.to_ell(pad_nodes_to=128, device="cpu")
    stats = {}
    a1 = td.get_adjacency(g, ell, stats=stats)
    assert stats["cached"] is False and stats["total_s"] >= stats["build_s"] >= 0
    stats = {}
    again = g.to_ell(pad_nodes_to=128, device="cpu")
    assert td.get_adjacency(g, again, stats=stats) is a1 and stats["cached"]
    a2 = td.get_adjacency(g, g.to_ell(pad_nodes_to=1024, device="cpu"))
    assert a2 is not a1 and a2.shape[0] == 1024
    assert torch.equal(a2[: ell.n_pad, : a1.shape[1]], a1) and not a2[ell.n_pad:].any()
    assert set(g._adj_cache) == {(ell.n_pad, "cpu"), (1024, "cpu")}
    assert np.array_equal(interop.adjacency_to_jax(a1),
                          np.asarray(jd.build_packed_adjacency(medium_er, ell.n_pad)))


def test_simple_certified_skips_nnz_check(small_er):
    """Mirrors test_simple_certified_skips_nnz_check; a graph that is not
    certified pays the check."""
    g = interop.graph_from_jax(small_er)
    assert g.simple_certified
    ell = g.to_ell(pad_nodes_to=8, device="cpu")
    with mock.patch.object(td, "check_adjacency_complete",
                           side_effect=AssertionError("must not be called")):
        td.get_adjacency(g, ell)
    g.simple_certified = False
    g.__dict__.pop("_adj_cache")
    with mock.patch.object(td, "check_adjacency_complete") as check:
        td.get_adjacency(g, ell)
    assert check.call_count == 1


@pytest.mark.parametrize("kind", [ProposalKind.BALANCE_DYNAMIC, ProposalKind.STANDARD])
def test_sweep_matmul_packed_matches_jax(medium_er, kind):
    """Mirrors test_sweep_matmul_packed_bitexact across packages: the
    port's packed sweep over its A against JAX's over JAX's packed A, from
    one state and one uniform vector."""
    g = interop.graph_from_jax(medium_er)
    je = medium_er.to_ell(pad_nodes_to=128)
    te = g.to_ell(pad_nodes_to=128, device="cpu")
    jp = JParams(n_colors=medium_er.max_degree, proposal=JKind(kind.value), taboo_iterations=3)
    pt = port_params(jp)
    adj_j = jd.build_packed_adjacency(medium_er, je.n_pad)
    adj_t = td.get_adjacency(g, te)
    rng = np.random.default_rng(13)
    colors = rng.integers(0, jp.n_colors, je.n_pad).astype(np.int32)
    colors[medium_er.n:] = jp.n_colors
    taboo = rng.integers(0, 2, je.n_pad).astype(np.int32)
    unif = rng.random(je.n_pad, dtype=np.float32)
    hist = j_hist(jnp.asarray(colors), jp.n_colors, je.node_mask)
    p_eff_j = jm._variant_distribution(jp, hist, medium_er.n)
    p_eff_t = tm._p_eff_of(torch.from_numpy(colors), pt, te.n_nodes, te.node_mask)
    star_j, taboo_j, logq_j, conf_j, nc_j = jm._sweep_matmul(
        je, adj_j, jp, 128, jnp.asarray(colors), jnp.asarray(taboo), jnp.asarray(unif), p_eff_j)
    before = k1.launches
    # the port's sweep has a chain axis: one chain here
    star_t, taboo_t, logq_t, conf_t, nc_t = (x[0] for x in tm._sweep_matmul(
        adj_t, pt, 128, torch.from_numpy(colors)[None], torch.from_numpy(taboo)[None],
        torch.from_numpy(unif)[None], None if p_eff_t is None else p_eff_t[None], te.n_nodes))
    assert k1.launches == before  # CPU: K1's plain version
    assert np.array_equal(nc_t.numpy(), np.asarray(nc_j))
    assert int(conf_t) == int(conf_j)
    p_pad = None
    if p_eff_j is not None:
        p_pad = jnp.zeros((nc_j.shape[1],), jnp.float32).at[: jp.n_colors].set(p_eff_j)
    q = jm._proposal_q(jnp.asarray(colors), nc_j > 0, jp, p_pad, n_colors=jp.n_colors)
    cdf = np.asarray(jnp.cumsum(q, axis=1))
    mism = assert_boundary_only(star_t.numpy(), np.asarray(star_j), unif, cdf, medium_er.n)
    keep = np.ones(je.n_pad, bool)
    keep[mism] = False
    assert np.array_equal(taboo_t.numpy()[keep], np.asarray(taboo_j)[keep])
    np.testing.assert_allclose(float(logq_t), float(logq_j), rtol=1e-4)


PACKED_CHAIN = {
    "default": dict(),
    "tight": dict(tight=True, taboo_iterations=2, max_iterations=6),
    "hastings_reject": dict(hastings=True, lambda_=1.0, max_iterations=3),
    "hastings_accept": dict(hastings=True, lambda_=25.0, max_iterations=3),
}


@pytest.mark.parametrize("case", list(PACKED_CHAIN))
def test_teacher_forced_packed_chain(medium_er, case):
    """JAX's MCMCColorer(backend="packed") do-while, body by body, against
    the port's ``_chain_body`` over the packed A it builds from the ELL
    (the JAX test's packed chain, test_chain_matmul_packed_valid, as the
    chain itself)."""
    kw = dict(PACKED_CHAIN[case])
    tight = kw.pop("tight", False)
    n_colors = medium_er.max_degree // 2 if tight or "hastings" in case else medium_er.max_degree
    jp = JParams(n_colors=n_colors, proposal=JKind.BALANCE_DYNAMIC, tailcut=True, **kw)
    c = jm.MCMCColorer(medium_er, jp, backend="packed")
    pt = port_params(jp)
    tc = tm.MCMCColorer(interop.graph_from_jax(medium_er), pt, block_size=c.block,
                        backend="packed", device="cpu")
    assert tc.ell.n_pad == c.ell.n_pad
    assert np.array_equal(interop.adjacency_to_jax(tc._adj), np.asarray(c._adj))
    key = rngu.for_repetition(rngu.root_key(3), 0)
    carry = c._jit_init(c.ell, key)
    bodies = accepted = 0
    while not bool(carry[6]) and int(carry[3]) < jp.max_iterations:
        if jp.hastings:
            _, k_u, k_acc = jax.random.split(carry[2], 3)
        else:
            _, k_u = jax.random.split(carry[2])
        unif = jax_uniform(k_u, (tc.ell.n_pad,))
        draws = [unif.copy()] + ([jax_uniform(k_acc, ())] if jp.hastings else [])
        source = Replay(draws)
        cdf = jax_cdf(c.ell, carry[0], jp)
        before = np.asarray(carry[0])
        got = tm._chain_body(tc._adj, carry_state(carry), RUN1, params=pt, block=c.block,
                             n_nodes=tc.ell.n_nodes, sources=one(source),
                             sweep=tm._sweep_matmul)
        assert not source.draws
        carry = c._jit_segment(c.ell, carry, jnp.int32(1))
        check_body(got, carry_state(carry), unif, cdf, tc.ell.n_nodes)
        accepted += not np.array_equal(np.asarray(carry[0]), before)
        bodies += 1
    assert bodies >= 2
    if jp.hastings:
        assert (accepted > 0) == (case == "hastings_accept")


@pytest.mark.parametrize("backend", ["matmul", "packed"])
def test_chain_matmul_packed_valid(medium_er, backend):
    """Mirrors test_chain_matmul_valid / test_chain_matmul_packed_valid."""
    g = interop.graph_from_jax(medium_er)
    p = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    c = tm.MCMCColorer(g, p, backend=backend, device="cpu")
    assert c.backend == "matmul" and c._adj is not None
    r = c.run(seed=21)
    assert check_coloring(g, r.colors) and r.extra["final_conflicts"] == 0
    assert r.extra["sweeps"] == r.iterations + 1  # the converged body included


def test_chain_matmul_hastings(small_er):
    """Mirrors test_chain_matmul_hastings."""
    g = interop.graph_from_jax(small_er)
    p = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC,
                   hastings=True, tailcut=True)
    r = tm.MCMCColorer(g, p, backend="packed", device="cpu").run(seed=5)
    assert check_coloring(g, r.colors)


@pytest.mark.parametrize("fixture", ["small_er", "medium_er"])
def test_luby_matmul_matches_jax(request, fixture):
    """Luby's matmul loop over a host graph on JAX's draws equals JAX's
    (``LubyColorer(g, backend="matmul")``) and the port's gather loop at
    the same padding, exactly."""
    jg = request.getfixturevalue(fixture)
    g = interop.graph_from_jax(jg)
    want = JLuby(jg, backend="matmul").run(seed=4)
    c = tl.LubyColorer(g, backend="matmul", device="cpu")
    assert c.backend == "matmul" and c.ell.n_pad == -(-g.n // 128) * 128
    got = c.run(seed=4, source=JaxKeySource(4))
    assert np.array_equal(got.colors, want.colors)
    assert got.n_colors == want.n_colors
    colors, n_colors, rounds = tl._run_luby(c.ell, JaxKeySource(4))
    assert np.array_equal(colors[: g.n].numpy(), got.colors)
    assert (n_colors, rounds) == (got.n_colors, got.extra["rounds"])
    assert_mis_classes(g, got.colors)
