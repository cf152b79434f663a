"""The port's ELL chain, flat tailcut, MCMCColorer, GreedyFF and colouring
statistics against the JAX package's.

- Teacher-forced chains: JAX's loop is stepped one body at a time; from
  each JAX state, brought over as numpy, the port runs one body on the
  uniforms JAX drew for it.  Integer state (iteration, exit flag,
  conflict counts, trace) must be equal; colours and taboo follow the
  sampling rule of ``test_torch_resample.py`` (differences only at
  CDF-boundary vertices, at most 0.1 %), since XLA and torch add the
  float32 prefix sums in different orders.
- The flat tailcut round, GreedyFF and the statistics are integer work,
  fed identical inputs (the round's random colours are JAX's own
  ``randint`` draws): exact.
- Whole runs: the port's own run (its own generator) must end valid
  with 0 conflicts on the same graph and palette as JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.config import MCMCParams as JParams
from mcmc_colorer_tpu.config import ProposalKind as JKind
from mcmc_colorer_tpu.models import base as jbase
from mcmc_colorer_tpu.models import mcmc as jm
from mcmc_colorer_tpu.models.greedy_ff import GreedyFFColorer as JGreedyFF
from mcmc_colorer_tpu.ops.neighbor import color_histogram as j_hist
from mcmc_colorer_tpu.ops.neighbor import neighbor_colors as j_nc
from mcmc_colorer_tpu.ops.neighbor import occupancy_matrix as j_occ
from mcmc_colorer_tpu.utils import rng as rngu

from mcmc_colorer_tpu_torch import interop
from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.models import base as tbase
from mcmc_colorer_tpu_torch.models import mcmc as tm
from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer
from mcmc_colorer_tpu_torch.ops import firstfit as k3
from mcmc_colorer_tpu_torch.ops import resample as k2
from mcmc_colorer_tpu_torch.utils.rng import ChainSources, TorchUniformSource

from test_torch_resample import assert_boundary_only

torch.set_num_threads(2)


class Replay:
    """A source that hands out pre-drawn JAX draws in order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def next(self, n):
        u = self.draws.pop(0)
        assert u.shape == (n,) and u.dtype == np.float32, (u.shape, n)
        return torch.from_numpy(u)

    def randint(self, n, high, low=0):
        r = self.draws.pop(0)
        assert r.shape == (n,) and r.dtype == np.int32 and r.max() < high
        return torch.from_numpy(r)


def jax_uniform(key, shape):
    return np.array(jax.random.uniform(key, shape, dtype=jnp.float32)).reshape(-1)


def port_params(jp) -> MCMCParams:
    return MCMCParams(
        n_colors=jp.n_colors, max_iterations=jp.max_iterations, epsilon=jp.epsilon,
        lambda_=jp.lambda_, taboo_iterations=jp.taboo_iterations, tailcut=jp.tailcut,
        proposal=ProposalKind(jp.proposal.value), hastings=jp.hastings,
    )


def carry_state(carry):
    return interop.carry_from_numpy(*(np.asarray(carry[i]) for i in (0, 1, 3, 4, 5, 6)))


# the port's chain core has a chain axis: these tests run one chain
RUN1 = np.ones(1, bool)


def one(source):
    return ChainSources([source], "cpu")


def jax_cdf(ell, colors, jp):
    """JAX's cdf for a sweep from ``colors`` (the XLA formulation, which
    its kernel matches bit for bit)."""
    hist = j_hist(colors, jp.n_colors, ell.node_mask)
    p_eff = jm._variant_distribution(jp, hist, ell.n_nodes)
    occ = j_occ(j_nc(ell.neighbors, colors), jp.n_colors)
    return np.asarray(jnp.cumsum(jm._proposal_q(colors, occ, jp, p_eff), axis=1))


def check_body(got, want, unif, cdf, n_nodes):
    for f in ("rip", "conf_last", "done", "trace"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    mism = assert_boundary_only(got.colors[0].numpy(), want.colors[0].numpy(), unif, cdf,
                                n_nodes)
    keep = np.ones(unif.shape[0], bool)
    keep[mism] = False
    assert np.array_equal(got.taboo[0].numpy()[keep], want.taboo[0].numpy()[keep])


FUSED = {
    "default": dict(),
    "tight": dict(tight=True, taboo_iterations=2, max_iterations=6),
}


@pytest.mark.parametrize("case", list(FUSED))
def test_teacher_forced_fused_chain(medium_er, case):
    """JAX's MCMCColorer(backend='pallas') do-while, body by body, against
    the port's ``_chain_body`` with the K2 sweep."""
    kw = dict(FUSED[case])
    n_colors = medium_er.max_degree // 2 if kw.pop("tight", False) else medium_er.max_degree
    jp = JParams(n_colors=n_colors, proposal=JKind.BALANCE_DYNAMIC, tailcut=True, **kw)
    c = jm.MCMCColorer(medium_er, jp, backend="pallas")
    pt = port_params(jp)
    te = interop.graph_from_jax(medium_er).to_ell(pad_nodes_to=c.block, pad_degree_to=8,
                                                  device="cpu")
    assert te.n_pad == c.ell.n_pad
    key = rngu.for_repetition(rngu.root_key(3), 0)
    carry = c._jit_init(c.ell, key)
    _, k_init = jax.random.split(key)
    init = tm._chain_init(te.n_pad, te.n_nodes, pt,
                          one(Replay([jax_uniform(k_init, (te.n_pad,))])), "cpu")
    assert np.array_equal(init.colors[0].numpy(), np.asarray(carry[0]))
    bodies = 0
    while not bool(carry[6]) and int(carry[3]) < jp.max_iterations:
        _, k_u = jax.random.split(carry[2])
        unif = jax_uniform(k_u, (te.n_pad,))
        source = Replay([unif.copy()])
        cdf = jax_cdf(c.ell, carry[0], jp)
        got = tm._chain_body(te, carry_state(carry), RUN1, params=pt, block=c.block,
                             n_nodes=te.n_nodes, sources=one(source),
                             sweep=tm._sweep_pallas_fused)
        assert not source.draws
        carry = c._jit_segment(c.ell, carry, jnp.int32(1))
        check_body(got, carry_state(carry), unif, cdf, te.n_nodes)
        bodies += 1
    assert bodies >= 2
    final = carry_state(carry)
    assert tm._chain_final_conflicts(te, final)[0] == int(
        jm._chain_final_conflicts(c.ell, carry))


GENERIC = {
    "xla": dict(),
    # λ = 1 rejects every early proposal, λ = 25 accepts some
    "hastings_reject": dict(hastings=True, lambda_=1.0),
    "hastings_accept": dict(hastings=True, lambda_=25.0),
}


@pytest.mark.parametrize("case", list(GENERIC))
def test_teacher_forced_generic_chain(medium_er, case):
    """JAX's generic loop (backend 'xla', and Hastings), body by body,
    against the port's ``_chain_body_generic``."""
    jp = JParams(n_colors=medium_er.max_degree // 2, proposal=JKind.BALANCE_DYNAMIC,
                 tailcut=True, max_iterations=3, **GENERIC[case])
    c = jm.MCMCColorer(medium_er, jp, backend="xla")
    pt = port_params(jp)
    te = interop.graph_from_jax(medium_er).to_ell(pad_nodes_to=c.block, pad_degree_to=8,
                                                  device="cpu")
    key = rngu.for_repetition(rngu.root_key(4), 0)
    carry = c._jit_init(c.ell, key)
    _, k_init = jax.random.split(key)
    init = tm._chain_init(te.n_pad, te.n_nodes, pt,
                          one(Replay([jax_uniform(k_init, (te.n_pad,))])), "cpu", ell=te)
    assert init.conf_last[0] == int(carry[4])
    assert np.array_equal(init.trace[0], np.asarray(carry[5]))
    bodies = accepted = 0
    while int(carry[4]) > jp.tailcut_threshold(medium_er.n) and int(carry[3]) < jp.max_iterations:
        _, k_u, k_acc = jax.random.split(carry[2], 3)
        unif = jax_uniform(k_u, (te.n_pad,))
        draws = [unif.copy()] + ([jax_uniform(k_acc, ())] if jp.hastings else [])
        source = Replay(draws)
        cdf = jax_cdf(c.ell, carry[0], jp)
        before = np.asarray(carry[0])
        got = tm._chain_body_generic(te, carry_state(carry), RUN1, params=pt, block=c.block,
                                     backend="xla", sources=one(source))
        assert not source.draws
        carry = c._jit_segment(c.ell, carry, jnp.int32(1))
        want = carry_state(carry)
        if jp.hastings and np.array_equal(np.asarray(carry[0]), before):
            # rejected on both sides: the colours are kept exactly
            assert np.array_equal(got.colors[0].numpy(), before)
        check_body(got, want, unif, cdf, te.n_nodes)
        accepted += not np.array_equal(np.asarray(carry[0]), before)
        bodies += 1
    assert bodies == 3
    if jp.hastings:
        assert (accepted > 0) == (case == "hastings_accept")


@pytest.mark.parametrize("n_colors", [None, 3], ids=["movable", "stalled"])
def test_tailcut_rounds_match_jax(medium_er, n_colors):
    """Flat tailcut rounds with JAX's own randint draws: colours, conflicts,
    rounds and the exit flag equal JAX's exactly.  With 3 colours no
    conflicted vertex has a free colour, so the stall escape runs."""
    n_colors = n_colors or medium_er.max_degree // 2
    jp = JParams(n_colors=n_colors, proposal=JKind.BALANCE_DYNAMIC, tailcut=True)
    pt = port_params(jp)
    je = medium_er.to_ell(pad_nodes_to=128)
    te = interop.graph_from_jax(medium_er).to_ell(pad_nodes_to=128, device="cpu")
    rng = np.random.default_rng(9)
    colors = rng.integers(0, n_colors, je.n_pad).astype(np.int32)
    colors[medium_er.n:] = n_colors
    cr_j, ord_j = jm._tailcut_init(je, jnp.asarray(colors), params=jp)
    cr_t, ord_t = tm._tailcut_init(te, torch.from_numpy(colors), params=pt)
    assert np.array_equal(cr_t.numpy(), np.asarray(cr_j))
    assert np.array_equal(ord_t.numpy(), np.asarray(ord_j))
    key = jax.random.key(6)
    body = jm._tailcut_body_flat(je, key, params=jp, block=128)
    cj = (cr_j, jnp.int32(0), jnp.int32(0), jnp.bool_(False))
    ct = tm.TailcutState(cr_t[None], np.zeros(1, np.int64), np.zeros(1, np.int64),
                         np.zeros(1, bool))
    for _ in range(3):
        rnd = np.array(jax.random.randint(jax.random.fold_in(key, cj[2]), (je.n_pad,), 0,
                                          n_colors, dtype=jnp.int32))
        ct = tm._tailcut_body(te, ct, RUN1, one(Replay([rnd])), params=pt)
        cj = body(cj)
        assert np.array_equal(ct.colors_r[0].numpy(), np.asarray(cj[0]))
        assert (ct.conflicts[0], ct.rounds[0], ct.done[0]) == (int(cj[1]), int(cj[2]),
                                                               bool(cj[3]))
    out_j = jm._tailcut_finish(je, cj[0], ord_j, params=jp)
    out_t = tm._tailcut_finish(te, ct.colors_r[0], ord_t, params=pt)
    assert np.array_equal(out_t.numpy(), np.asarray(out_j))
    if n_colors == 3:
        # the escape moved someone
        assert not np.array_equal(ct.colors_r[0].numpy(), cr_t.numpy())


def test_super_blocks_do_not_change_the_sweep(medium_er, monkeypatch):
    """Mirrors test_fused_sweep_super_blocked_bitexact: row bands only
    bound memory."""
    te = interop.graph_from_jax(medium_er).to_ell(pad_nodes_to=128, device="cpu")
    p = MCMCParams(n_colors=medium_er.max_degree, taboo_iterations=2)
    rng = np.random.default_rng(3)
    colors = torch.from_numpy(rng.integers(0, p.n_colors, te.n_pad).astype(np.int32))
    taboo = torch.zeros(te.n_pad, dtype=torch.int32)
    unif = torch.from_numpy(rng.random(te.n_pad, dtype=np.float32))
    p_eff = tm._p_eff_of(colors, p, te.n_nodes, te.node_mask)
    args = (colors[None], taboo[None], unif[None], p_eff[None])  # one chain
    assert tm._fused_super_block(te.n_pad, te.d_pad) == te.n_pad
    ref = tm._sweep_pallas_fused(te, p, 128, *args)
    monkeypatch.setattr(tm, "_FUSED_NC_BYTES_CAP", 128 * te.d_pad * tm._SLOT_BYTES)
    assert tm._fused_super_block(te.n_pad, te.d_pad) == 128
    got = tm._sweep_pallas_fused(te, p, 128, *args)
    for a, b in zip(ref[:2], got[:2]):
        assert torch.equal(a, b)
    assert np.isclose(float(ref[2][0]), float(got[2][0]), rtol=1e-5)
    assert int(ref[3][0]) == int(got[3][0]) == int(tbase.count_conflict_edges(te, colors))
    assert tm._sweep(te, p, 128, *args)[0].equal(ref[0])


@pytest.mark.parametrize("kind", [ProposalKind.BALANCE_DYNAMIC, ProposalKind.DECREASE_EXP])
def test_ell_sweep_bands_or_one_piece(medium_er, monkeypatch, kind):
    """The plain sweep gives bit-equal results in row bands and in one
    piece (K2 runs in one piece on the card); phantom rows keep their
    colour, no taboo, log qstar 0."""
    te = interop.graph_from_jax(medium_er).to_ell(pad_nodes_to=128, device="cpu")
    p = MCMCParams(n_colors=medium_er.max_degree, proposal=kind, taboo_iterations=2)
    rng = np.random.default_rng(4)
    colors = rng.integers(0, p.n_colors, te.n_pad).astype(np.int32)
    colors[te.n_nodes:] = p.n_colors
    colors = torch.from_numpy(colors)
    taboo = torch.from_numpy(rng.integers(0, 2, te.n_pad).astype(np.int32))
    unif = torch.from_numpy(rng.random(te.n_pad, dtype=np.float32))
    p_eff = tm._p_eff(colors[None], p, te.n_nodes, te.node_mask)
    args = (colors[None], taboo[None], unif[None], p_eff, None)  # one chain
    assert te.n_pad > te.n_nodes
    whole = tm._ell_sweep(te, p, *args, k2.resample_sweep_plain, bands=False)
    monkeypatch.setattr(tm, "_FUSED_NC_BYTES_CAP", 128 * te.d_pad * tm._SLOT_BYTES)
    assert len(list(tm._bands(te.n_nodes, te.d_pad))) > 1
    banded = tm._ell_sweep(te, p, *args, k2.resample_sweep_plain)
    for a, b in zip(whole, banded):
        assert torch.equal(a, b)
    phantom = ~te.node_mask
    assert torch.equal(whole[0][0][phantom], colors[phantom])
    assert not whole[1][0][phantom].any()
    assert int(whole[3][0]) == int(tbase.count_conflict_edges(te, colors))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_whole_slice(medium_er, backend):
    """MCMCColorer on medium_er ends valid with 0 conflicts, at JAX's
    palette; a palette of max degree / 3 makes the tailcut work."""
    g = interop.graph_from_jax(medium_er)
    n_colors = jm.MCMCColorer(
        medium_er, JParams(n_colors=medium_er.max_degree), backend="xla"
    ).params.n_colors
    for n_col, max_it in ((n_colors, 250), (max(4, n_colors // 3), 40)):
        p = MCMCParams(n_colors=n_col, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True,
                       taboo_iterations=2, max_iterations=max_it)
        before = (k2.launches, k3.launches)
        r = tm.MCMCColorer(g, p, backend=backend, device="cpu").run(seed=31)
        assert (k2.launches, k3.launches) == before  # CPU: the plain versions
        assert r.extra["final_conflicts"] == 0 and r.extra["tailcut_rounds"] >= 1
        assert r.colors.shape == (g.n,) and r.colors.max() < n_col
        assert tbase.check_coloring(g, r.colors) and jbase.check_coloring(medium_er, r.colors)
        assert r.conflict_trace.shape == (r.iterations + 1,)


def test_hastings_run_and_unported_paths(medium_er, monkeypatch):
    g = interop.graph_from_jax(medium_er)
    p = MCMCParams(n_colors=g.max_degree, hastings=True, lambda_=25.0, tailcut=True,
                   max_iterations=5)
    r = tm.MCMCColorer(g, p, backend="pallas", device="cpu").run(seed=2)
    assert r.extra["final_conflicts"] == 0 and tbase.check_coloring(g, r.colors)
    # the bucketed layout runs Hastings too; matmul refuses it, as in JAX
    r = tm.MCMCColorer(g, p, layout="bucketed", device="cpu").run(seed=2)
    assert r.extra["final_conflicts"] == 0 and tbase.check_coloring(g, r.colors)
    with pytest.raises(ValueError, match="flat-layout only"):
        tm.MCMCColorer(g, p, backend="matmul", layout="bucketed", device="cpu")
    # the packed chain over a host graph (K1's plain version here) with Hastings
    r = tm.MCMCColorer(g, p, backend="matmul", device="cpu").run(seed=2)
    assert r.extra["final_conflicts"] == 0 and tbase.check_coloring(g, r.colors)
    with pytest.raises(ValueError, match="backend"):
        tm.MCMCColorer(g, p, backend="nope", device="cpu")
    # the frontier GreedyFF is ported: it runs and equals the full loop
    assert np.array_equal(GreedyFFColorer(g, active=True, device="cpu").run().colors,
                          GreedyFFColorer(g, device="cpu").run().colors)
    # and so is the bucketed one, full and frontier
    buck = GreedyFFColorer(g, layout="bucketed", device="cpu").run()
    assert tbase.check_coloring(g, buck.colors)
    assert np.array_equal(GreedyFFColorer(g, layout="bucketed", active=True,
                                          device="cpu").run().colors, buck.colors)
    # the free-colour TRACE is ported: the same colouring, and a line a segment
    plain = tm.MCMCColorer(g, p, device="cpu").run(seed=1)
    monkeypatch.setenv("MCMC_COLORER_TRACE", "1")
    traced = tm.MCMCColorer(g, p, device="cpu").run(seed=1)
    assert np.array_equal(traced.colors, plain.colors)
    assert len(traced.extra["free_color_trace_segments"]) >= 1


@pytest.mark.parametrize("fixture", ["small_er", "medium_er"])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_greedy_ff_matches_jax(request, fixture, backend):
    """GreedyFF is deterministic: the port's colours equal JAX's."""
    jg = request.getfixturevalue(fixture)
    want = JGreedyFF(jg).run()
    got = GreedyFFColorer(interop.graph_from_jax(jg), backend=backend, device="cpu").run()
    assert np.array_equal(got.colors, want.colors)
    assert (got.n_colors, got.iterations) == (want.n_colors, want.iterations)
    assert got.extra == want.extra


def test_coloring_stats_match_jax(medium_er):
    rng = np.random.default_rng(5)
    colors = rng.integers(0, 17, medium_er.n).astype(np.int32)
    colors[colors == 11] = 3  # an unused colour
    a = tbase.build_coloring(None, colors, 17, iterations=4)
    b = jbase.build_coloring(medium_er, colors, 17, iterations=4)
    assert np.array_equal(a.histogram, b.histogram)
    assert a.used_colors == b.used_colors == 16
    assert a.class_stats() == b.class_stats()
    assert a.balance_index(0.05) == b.balance_index(0.05)
    assert a.balance_index(0.0) == b.balance_index(0.0)
    assert a.efficiency_num_processors(4) == b.efficiency_num_processors(4)
    assert a.ascii_histogram(20) == b.ascii_histogram(20)
    for x, y in zip(a.color_classes, b.color_classes):
        assert np.array_equal(x, y)
    g = interop.graph_from_jax(medium_er)
    for x, y in zip(a.class_degree_stats(g), b.class_degree_stats(medium_er)):
        assert np.array_equal(x, y)


def test_checks_match_jax(medium_er, monkeypatch):
    """check_coloring walks the CSR in row bands with the same verdict;
    the ELL-side counts equal JAX's."""
    g = interop.graph_from_jax(medium_er)
    valid = JGreedyFF(medium_er).run().colors
    rng = np.random.default_rng(8)
    bad = valid.copy()
    bad[rng.integers(0, g.n, 3)] = valid[0]
    partial = np.where(rng.random(g.n) < 0.3, -1, valid).astype(np.int32)
    for band in (tbase.CHECK_BAND_EDGES, 64, 1):
        monkeypatch.setattr(tbase, "CHECK_BAND_EDGES", band)
        for colors in (valid, bad, partial):
            for allow in (False, True):
                assert tbase.check_coloring(g, colors, allow) == jbase.check_coloring(
                    medium_er, colors, allow
                )
    je = medium_er.to_ell(pad_nodes_to=128)
    te = g.to_ell(pad_nodes_to=128, device="cpu")
    for colors in (valid, bad):
        padded = np.full(te.n_pad, -1, np.int32)
        padded[: g.n] = colors
        assert int(tbase.count_conflict_edges(te, torch.from_numpy(padded))) == int(
            jbase.count_conflict_edges(je, jnp.asarray(padded))
        )
        assert np.array_equal(
            tbase.violating_nodes(te, torch.from_numpy(padded)).numpy(),
            np.asarray(jbase.violating_nodes(je, jnp.asarray(padded))),
        )


def test_randint_source():
    a = TorchUniformSource(3, 1, "cpu")
    b = TorchUniformSource(3, 1, "cpu")
    r = a.randint(1000, 7)
    assert r.dtype == torch.int32 and r.shape == (1000,)
    assert int(r.min()) == 0 and int(r.max()) == 6
    assert torch.equal(r, b.randint(1000, 7))
