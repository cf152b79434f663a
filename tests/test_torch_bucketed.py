"""The port's degree-bucketed ELL layout (``layout="bucketed"``) against
the JAX package's, on the CPU.

- The layout: ``to_ell_bucketed`` equals JAX's field for field (slices,
  starts, real rows, degrees, ``node_mask``, ``real_positions``,
  ``gather_elements``) for ascending and descending ids, lanes of 8 and
  128 and JAX's fold rules; ``take_rows`` over it equals JAX's.
- The chain's pieces, fed one numpy-made state and JAX's layout
  (``interop.bucketed_from_jax``): the conflict count, ``cnt`` and the
  tailcut round (JAX's own ``randint`` draws) are integer work and exact;
  the sweeps (JAX's K2 in interpret mode, one call a degree class, and
  its XLA sweep) follow the CDF-boundary rule of
  ``tests/test_torch_resample.py`` for the sampled colours, with exact
  conflicts, and taboo exact where the colours agree; Hastings' reverse
  probability within rtol 1e-5, as the flat one.
- Whole runs: GreedyFF and VFF are deterministic, Luby is fed JAX's
  draws, so their colours equal JAX's exactly, full and frontier, with
  the backend pinned on both sides (it picks the lane width: 128 for
  ``pallas``, 8 for ``xla``); the MCMC chains run on the port's own draws
  and must end valid and statistically like the flat layout
  (``tests/test_mcmc.py:199-264``, ``tests/test_mcmc_active.py:86-122``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.analysis.log_parser import parse_results_dir
from mcmc_colorer_tpu.cli import main as jax_main
from mcmc_colorer_tpu.config import MCMCParams as JParams
from mcmc_colorer_tpu.config import ProposalKind as JKind
from mcmc_colorer_tpu.graph.generate import barabasi_albert as j_ba
from mcmc_colorer_tpu.models import mcmc as jm
from mcmc_colorer_tpu.models import mcmc_active as ja
from mcmc_colorer_tpu.models.greedy_ff import GreedyFFColorer as JGreedyFF
from mcmc_colorer_tpu.models.luby import LubyColorer as JLuby
from mcmc_colorer_tpu.models.vff import VFFColorer as JVFF
from mcmc_colorer_tpu.ops.neighbor import color_histogram as j_hist
from mcmc_colorer_tpu.ops.neighbor import neighbor_colors as j_nc
from mcmc_colorer_tpu.ops.neighbor import occupancy_matrix as j_occ
from mcmc_colorer_tpu.ops.neighbor import take_rows as j_take_rows
from mcmc_colorer_tpu.ops.pallas_firstfit import pallas_first_fit
from mcmc_colorer_tpu.utils import rng as rngu

from mcmc_colorer_tpu_torch import interop
from mcmc_colorer_tpu_torch.cli import main as cli_main
from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.models import mcmc as tm
from mcmc_colorer_tpu_torch.models import mcmc_active as ta
from mcmc_colorer_tpu_torch.models.base import check_coloring
from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer
from mcmc_colorer_tpu_torch.models.luby import LubyColorer
from mcmc_colorer_tpu_torch.models.vff import VFFColorer
from mcmc_colorer_tpu_torch.ops import firstfit as k3
from mcmc_colorer_tpu_torch.ops import resample as k2
from mcmc_colorer_tpu_torch.ops.neighbor import frontier_ids, take_rows

from test_torch_active import Replay
from test_torch_luby import JaxKeySource, assert_mis_classes
from test_torch_mcmc import RUN1, carry_state, jax_uniform, one, port_params
from test_torch_resample import assert_boundary_only

torch.set_num_threads(2)

GRAPHS = ["small_er", "medium_er", "ba"]


@pytest.fixture(scope="module")
def ba():
    """BA(2000, 8), seed 1: max degree 210 against a mean of 16, the skew
    the layout exists for."""
    return j_ba(2000, 8, seed=1, use_native=False)


def t(x):
    return torch.from_numpy(np.array(x))


def layouts(jg, descending=False, min_lane=128):
    """(JAX layout, the port's copy of it) of ``jg`` relabelled by degree."""
    jb = jg.degree_relabel(descending=descending)[0].to_ell_bucketed(block=128,
                                                                     min_lane=min_lane)
    return jb, interop.bucketed_from_jax(jb)


def random_state(jb, n_colors, seed, taboo_max=2):
    """Colours in the palette on real rows (nCol on phantoms, as
    ``_init_colors`` leaves them), taboo in [0, taboo_max], uniforms."""
    rng = np.random.default_rng(seed)
    mask = np.asarray(jb.node_mask)
    colors = np.where(mask, rng.integers(0, n_colors, jb.n_pad), n_colors).astype(np.int32)
    taboo = np.where(mask, rng.integers(0, taboo_max + 1, jb.n_pad), 0).astype(np.int32)
    return colors, taboo, rng.random(jb.n_pad, dtype=np.float32)


# ------------------------------- the layout -------------------------------


def assert_same_layout(tb, jb):
    got, want = interop.bucketed_to_numpy(tb), interop.bucketed_to_numpy(jb)
    assert got.keys() == want.keys()
    for k in want:
        if k == "neighbors":
            assert len(got[k]) == len(want[k])
            for a, b in zip(got[k], want[k]):
                assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
        else:
            assert np.array_equal(got[k], want[k]), k
    assert (tb.n_pad, tb.gather_elements) == (jb.n_pad, jb.gather_elements)
    assert np.array_equal(tb.node_mask.numpy(), np.asarray(jb.node_mask))
    assert np.array_equal(tb.real_positions(), jb.real_positions())


@pytest.mark.parametrize("fixture", GRAPHS)
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("min_lane", [8, 128])
def test_to_ell_bucketed_matches_jax(request, fixture, descending, min_lane):
    """Field for field, and the structure of tests/test_graph.py:193:
    block-multiple heights, the sentinel n_pad, every real row holding
    exactly its neighbours; each slice a contiguous tensor of its own."""
    jg = request.getfixturevalue(fixture)
    jg2, jperm = jg.degree_relabel(descending=descending)
    tg2, tperm = interop.graph_from_jax(jg).degree_relabel(descending=descending)
    assert np.array_equal(tperm, jperm)
    jb = jg2.to_ell_bucketed(block=128, min_lane=min_lane)
    tb = tg2.to_ell_bucketed(block=128, min_lane=min_lane, device="cpu")
    assert_same_layout(tb, jb)
    assert_same_layout(interop.bucketed_from_jax(jb), jb)
    assert int(tb.node_mask.sum()) == jg.n
    ptrs = {s.neighbors.data_ptr() for s in tb.slices}
    assert len(ptrs) == len(tb.slices) and all(s.neighbors.is_contiguous() for s in tb.slices)
    widths = [s.d_pad for s in tb.slices]
    assert widths == sorted(widths, reverse=descending)
    assert all(w % min_lane == 0 for w in widths)
    pos = tb.real_positions()
    inv_pos = np.full(tb.n_pad + 1, -1, np.int64)
    inv_pos[pos] = np.arange(jg.n)
    for s in tb.slices:
        assert s.h_pad % 128 == 0 and int(s.neighbors.max()) <= tb.n_pad
        nb = s.neighbors.numpy()
        assert (nb[s.n_real:] == tb.n_pad).all()
        for r in range(0, s.n_real, max(1, s.n_real // 7)):
            v = inv_pos[s.start + r]
            got = sorted(inv_pos[x] for x in nb[r] if x < tb.n_pad)
            assert got == sorted(tg2.neighbors_of(int(v)).tolist())


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("block", [32, 512])
def test_bucketed_fold_rules(ba, descending, block):
    """Under-filled classes fold as JAX folds them: into the next wider
    class on ascending ids, into the previous (wider) one on descending
    ids; the layout saves gather volume on the skewed graph
    (tests/test_graph.py:220)."""
    g2 = interop.graph_from_jax(ba).degree_relabel(descending=descending)[0]
    jb = ba.degree_relabel(descending=descending)[0].to_ell_bucketed(block=block, min_lane=8)
    tb = g2.to_ell_bucketed(block=block, min_lane=8, device="cpu")
    assert_same_layout(tb, jb)
    widths = [8, 32, 128, 216]  # 8 · 4^k up to the max degree, 210, rounded up to 8
    assert ba.max_degree == 210
    classes = np.unique(np.searchsorted(widths, ba.degrees))
    assert len(classes) == 4
    if block == 512:
        assert len(tb.slices) < len(classes)
    # every class but the last (ascending) holds a block of real rows; on
    # descending ids every class does, unless one class holds them all
    rest = tb.slices if descending else tb.slices[:-1]
    assert len(tb.slices) == 1 or all(s.n_real >= block for s in rest)
    if block == 32:
        flat = interop.graph_from_jax(ba).to_ell(device="cpu")
        assert tb.gather_elements < flat.n_pad * flat.d_pad / 3
    with pytest.raises(ValueError, match="degree-monotonic"):
        interop.graph_from_jax(ba).to_ell_bucketed(device="cpu")


@pytest.mark.parametrize("min_lane", [8, 128])
def test_take_rows_bucketed_matches_jax(ba, min_lane):
    """The frontier's rows gathered from the degree classes, widened to the
    widest one with the sentinel, for random frontiers and caps."""
    jb, tb = layouts(ba, descending=True, min_lane=min_lane)
    rng = np.random.default_rng(2)
    mask = (rng.random(jb.n_pad) < 0.2) & np.asarray(jb.node_mask)
    for cap in (128, jb.n_pad, int(mask.sum()) // 2):
        (jids,) = jnp.nonzero(jnp.asarray(mask), size=cap, fill_value=jb.n_pad)
        ids, valid = frontier_ids(torch.from_numpy(mask), cap)
        assert np.array_equal(ids.numpy(), np.asarray(jids))
        want = np.asarray(j_take_rows(jb, jids, jids < jb.n_pad))
        got = take_rows(tb, ids, valid)
        assert got.is_contiguous() and np.array_equal(got.numpy(), want)
        assert got.shape[1] == max(s.d_pad for s in tb.slices)


# ---------------------------- the chain's pieces ----------------------------


@pytest.mark.parametrize("min_lane", [8, 128])
def test_conflict_edges_and_cnt_exact(ba, min_lane):
    jb, tb = layouts(ba, min_lane=min_lane)
    colors, _, _ = random_state(jb, 12, seed=3)
    want = int(jm._conflict_edges_bucketed(jb, jnp.asarray(colors)))
    assert int(tm._conflict_edges(tb, t(colors)[None])[0]) == want > 0
    cnt = ta._cnt_of(tb, t(colors))
    assert np.array_equal(cnt.numpy(), np.asarray(ja._cnt_of(jb, jnp.asarray(colors),
                                                             params=None)))
    assert int(cnt.sum()) == 2 * want


def jax_cdf_bucketed(jb, colors, jp, p_eff):
    """JAX's cdf of every row's proposal, a degree class at a time."""
    parts = []
    for s in jb.slices:
        occ = j_occ(j_nc(s.neighbors, colors), jp.n_colors)
        cur = jax.lax.slice(colors, (s.start,), (s.start + s.h_pad,))
        parts.append(jnp.cumsum(jm._proposal_q(cur, occ, jp, p_eff), axis=1))
    return np.asarray(jnp.concatenate(parts))


SWEEPS = {
    "pallas_balance_dynamic": ("pallas", JKind.BALANCE_DYNAMIC),
    "pallas_decrease_exp": ("pallas", JKind.DECREASE_EXP),
    "xla_balance_dynamic": ("xla", JKind.BALANCE_DYNAMIC),
    "xla_standard": ("xla", JKind.STANDARD),
}


@pytest.mark.parametrize("case", list(SWEEPS))
def test_bucketed_sweep_matches_jax(ba, case):
    """One sweep from one state on the same uniforms: the port's
    ``_sweep_pallas_fused`` (K2's plain version, a degree class at a time)
    against JAX's ``_sweep_pallas_fused_bucketed`` (its Pallas kernel in
    interpret mode), and the port's ``_sweep`` against JAX's
    ``_sweep_bucketed``, each on its backend's lanes."""
    backend, kind = SWEEPS[case]
    jb, tb = layouts(ba, min_lane=128 if backend == "pallas" else 8)
    n_colors = 14
    jp = JParams(n_colors=n_colors, proposal=kind, taboo_iterations=2, epsilon=1e-4)
    pt = port_params(jp)
    colors, taboo, unif = random_state(jb, n_colors, seed=5)
    hist = j_hist(jnp.asarray(colors), n_colors, jb.node_mask)
    p_eff = jm._variant_distribution(jp, hist, jb.n_nodes)
    args_j = (jnp.asarray(colors), jnp.asarray(taboo), jnp.asarray(unif), p_eff)
    p_eff_t = None if p_eff is None else t(p_eff)[None]
    args_t = (t(colors)[None], t(taboo)[None], t(unif)[None], p_eff_t)  # one chain
    if backend == "pallas":
        star_j, taboo_j, logq_j, conf_j = jm._sweep_pallas_fused_bucketed(jb, jp, 128, *args_j)
        star_t, taboo_t, logq_t, conf_t = (
            x[0] for x in tm._sweep_pallas_fused(tb, pt, 128, *args_t))
        assert int(conf_t) == int(conf_j) == int(jm._conflict_edges_bucketed(jb, args_j[0])) > 0
    else:
        star_j, taboo_j, logq_j = jm._sweep_bucketed(jb, jp, 128, *args_j)
        star_t, taboo_t, logq_t = (x[0] for x in tm._sweep(tb, pt, 128, *args_t))
    cdf = jax_cdf_bucketed(jb, args_j[0], jp, p_eff)
    mism = assert_boundary_only(star_t.numpy(), np.asarray(star_j), unif, cdf, jb.n_nodes)
    keep = np.ones(jb.n_pad, bool)
    keep[mism] = False
    assert np.array_equal(taboo_t.numpy()[keep], np.asarray(taboo_j)[keep])
    phantom = ~np.asarray(jb.node_mask)
    assert np.array_equal(star_t.numpy()[phantom], colors[phantom])
    assert not taboo_t.numpy()[phantom].any()
    assert (star_t.numpy() != colors).any()
    if not mism.size:
        np.testing.assert_allclose(float(logq_t), float(logq_j), rtol=1e-5)


@pytest.mark.parametrize("min_lane", [8, 128])
def test_reverse_logq_bucketed_matches_jax(ba, min_lane):
    """Hastings' reverse probability from the star colouring's occupancy,
    a degree class at a time, within the flat test's rtol."""
    jb, tb = layouts(ba, min_lane=min_lane)
    n_colors = 14
    colors, _, _ = random_state(jb, n_colors, seed=1)
    star, _, _ = random_state(jb, n_colors, seed=2)
    jp = JParams(n_colors=n_colors, hastings=True)
    want = jm._reverse_logq_bucketed(jb, jp, 128, jnp.asarray(colors), jnp.asarray(star))
    got = tm._reverse_logq(tb, port_params(jp), 128, t(colors), t(star))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("n_colors", [None, 3], ids=["movable", "stalled"])
def test_bucketed_tailcut_rounds_match_jax(ba, n_colors):
    """JAX's ``_tailcut_body_bucketed`` against the port's ``_tailcut_body``
    (K3's plain version a degree class at a time) with JAX's randint
    draws: colours, conflicts, rounds and the exit flag exactly."""
    n_colors = n_colors or 12
    jb, tb = layouts(ba, min_lane=8)
    jp = JParams(n_colors=n_colors, proposal=JKind.BALANCE_DYNAMIC, tailcut=True)
    pt = port_params(jp)
    colors, _, _ = random_state(jb, n_colors, seed=9)
    cr_j, ord_j = jm._tailcut_init(jb, jnp.asarray(colors), params=jp)
    cr_t, ord_t = tm._tailcut_init(tb, t(colors), params=pt)
    assert np.array_equal(cr_t.numpy(), np.asarray(cr_j))
    key = jax.random.key(6)
    body = jm._tailcut_body_bucketed(jb, key, params=jp, block=128)
    cj = (cr_j, jnp.int32(0), jnp.int32(0), jnp.bool_(False))
    ct = tm.TailcutState(cr_t[None], np.zeros(1, np.int64), np.zeros(1, np.int64),
                         np.zeros(1, bool))  # one chain
    for _ in range(3):
        rnd = np.array(jax.random.randint(jax.random.fold_in(key, cj[2]), (jb.n_pad,), 0,
                                          n_colors, dtype=jnp.int32))
        ct = tm._tailcut_body(tb, ct, RUN1, one(Replay([rnd])), params=pt)
        cj = body(cj)
        assert np.array_equal(ct.colors_r[0].numpy(), np.asarray(cj[0]))
        assert (ct.conflicts[0], ct.rounds[0], ct.done[0]) == (int(cj[1]), int(cj[2]),
                                                               bool(cj[3]))
    out_j = jm._tailcut_finish(jb, cj[0], ord_j, params=jp)
    assert np.array_equal(tm._tailcut_finish(tb, ct.colors_r[0], ord_t, params=pt).numpy(),
                          np.asarray(out_j))
    if n_colors == 3:
        assert not np.array_equal(ct.colors_r[0].numpy(), cr_t.numpy())


def test_teacher_forced_bucketed_fused_chain(ba):
    """JAX's MCMCColorer(backend='pallas', layout='bucketed') do-while,
    body by body, against the port's ``_chain_body`` with the K2 sweep
    over the same layout (the initial colouring from JAX's n_pad draws,
    masked by the interleaved node_mask)."""
    jp = JParams(n_colors=14, proposal=JKind.BALANCE_DYNAMIC, tailcut=True,
                 taboo_iterations=2, max_iterations=5)
    c = jm.MCMCColorer(ba, jp, backend="pallas", layout="bucketed")
    pt = port_params(jp)
    tb = interop.bucketed_from_jax(c.ell)
    key = rngu.for_repetition(rngu.root_key(3), 0)
    carry = c._jit_init(c.ell, key)
    _, k_init = jax.random.split(key)
    init = tm._chain_init(tb.n_pad, tb.n_nodes, pt,
                          one(Replay([jax_uniform(k_init, (tb.n_pad,))])), "cpu",
                          node_mask=tb.node_mask)
    assert np.array_equal(init.colors[0].numpy(), np.asarray(carry[0]))
    bodies = 0
    while not bool(carry[6]) and int(carry[3]) < jp.max_iterations:
        _, k_u = jax.random.split(carry[2])
        unif = jax_uniform(k_u, (tb.n_pad,))
        hist = j_hist(carry[0], jp.n_colors, c.ell.node_mask)
        cdf = jax_cdf_bucketed(c.ell, carry[0], jp,
                               jm._variant_distribution(jp, hist, ba.n))
        got = tm._chain_body(tb, carry_state(carry), RUN1, params=pt, block=c.block,
                             n_nodes=tb.n_nodes, sources=one(Replay([unif.copy()])),
                             sweep=tm._sweep_pallas_fused)
        carry = c._jit_segment(c.ell, carry, jnp.int32(1))
        want = carry_state(carry)
        for f in ("rip", "conf_last", "done"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        mism = assert_boundary_only(got.colors[0].numpy(), want.colors[0].numpy(), unif, cdf,
                                    ba.n)
        keep = np.ones(tb.n_pad, bool)
        keep[mism] = False
        assert np.array_equal(got.taboo[0].numpy()[keep], want.taboo[0].numpy()[keep])
        bodies += 1
    assert bodies >= 2


def test_k3_ignores_colours_outside_a_cut_palette():
    """GreedyFF cuts K3's palette to d_b + 1 on a class of width d_b, so
    neighbours in wider classes can hold colours at or above it: K3's
    plain version drops them, as JAX's occupancy and ``pallas_first_fit``
    (interpret mode) do, and picks a colour below the palette."""
    rng = np.random.default_rng(4)
    d_b, pal, n_ids = 8, 9, 300
    colors = rng.integers(pal, 40, n_ids).astype(np.int32)  # ids 40.. hold colours >= pal
    colors[:40] = rng.integers(0, pal, 40)
    ids = rng.integers(0, n_ids + 1, (256, d_b)).astype(np.int32)
    ids[:64, :] = rng.integers(40, n_ids, (64, d_b))  # rows of out-of-palette colours only
    allow = np.ones(pal, np.int32)
    ext = np.concatenate([colors, [-1]]).astype(np.int32)
    want = np.asarray(pallas_first_fit(jnp.asarray(ext[ids]), jnp.asarray(allow), n_colors=pal,
                                       block=128, interpret=True))
    got = k3.first_fit(t(ids), t(colors), t(allow), pal).numpy()
    assert np.array_equal(got, want)
    assert (got >= 0).all() and (got < pal).all()
    assert (got[:64] == 0).all() and (ext[ids[:64]] >= pal).all()
    for r in range(0, 256, 17):
        used = {int(c) for c in ext[ids[r]] if 0 <= c < pal}
        assert got[r] == min(set(range(pal)) - used)


# ------------------------------- whole runs -------------------------------


@pytest.mark.parametrize("fixture", GRAPHS)
@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("active", [False, True])
def test_bucketed_greedy_ff_matches_jax(request, fixture, backend, active):
    """Bucketed GreedyFF (descending ids, K3's palette cut to d_b + 1 a
    class): JAX's colours, rounds and colour count exactly; the frontier
    loop equals the full one (tests/test_init_colorers.py:127-188)."""
    jg = request.getfixturevalue(fixture)
    g = interop.graph_from_jax(jg)
    want = JGreedyFF(jg, backend=backend, active=active, layout="bucketed").run()
    before = k3.launches
    c = GreedyFFColorer(g, backend=backend, active=active, layout="bucketed", device="cpu")
    got = c.run()
    assert k3.launches == before  # CPU tensors: K3's plain version
    assert np.array_equal(got.colors, want.colors)
    assert (got.n_colors, got.iterations, got.extra) == (want.n_colors, want.iterations,
                                                         want.extra)
    assert check_coloring(g, got.colors) and got.n_colors <= g.max_degree + 1
    other = GreedyFFColorer(g, backend=backend, active=not active, layout="bucketed",
                            device="cpu").run()
    assert np.array_equal(other.colors, got.colors) and other.iterations == got.iterations


@pytest.mark.parametrize("fixture", GRAPHS)
@pytest.mark.parametrize("active", [False, True])
def test_bucketed_vff_matches_jax(request, fixture, active):
    """Bucketed VFF, full and frontier (phase 2: K3 with allow and cur at
    the whole palette, a class at a time): JAX's colours, used colours,
    rounds and livelock flag."""
    jg = request.getfixturevalue(fixture)
    g = interop.graph_from_jax(jg)
    backend = "xla" if active else "pallas"
    want = JVFF(jg, backend=backend, active=active, layout="bucketed").run()
    c = VFFColorer(g, backend=backend, active=active, layout="bucketed", device="cpu")
    got = c.run()
    assert np.array_equal(got.colors, want.colors)
    assert (got.n_colors, got.iterations, got.extra) == (want.n_colors, want.iterations,
                                                         want.extra)
    assert check_coloring(g, got.colors) and int(got.colors.max()) < got.n_colors
    assert c.phase2_colors.shape == (g.n,)


@pytest.mark.parametrize("fixture", GRAPHS)
@pytest.mark.parametrize("active", [False, True])
def test_bucketed_luby_matches_jax(request, fixture, active):
    """Bucketed Luby on JAX's draws (n_pad a round in the full loop, the
    rung's cap in the frontier loop): JAX's colours exactly, and every
    class a maximal independent set of what was left."""
    jg = request.getfixturevalue(fixture)
    g = interop.graph_from_jax(jg)
    want = JLuby(jg, active=active, layout="bucketed").run(seed=2)
    src = JaxKeySource(2)
    c = LubyColorer(g, active=active, layout="bucketed", device="cpu")
    got = c.run(seed=2, source=src)
    assert np.array_equal(got.colors, want.colors)
    assert (got.n_colors, got.iterations) == (want.n_colors, want.iterations)
    if not active:
        assert set(src.sizes) == {c.ell.n_pad}
    assert_mis_classes(g, got.colors)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_bucketed_mcmc_converges(medium_er, backend):
    """tests/test_mcmc.py:test_bucketed_layout_converges, with a palette
    tight enough that the chain and the tailcut both work; K2 and K3 are
    not launched on the CPU."""
    g = interop.graph_from_jax(medium_er)
    p = MCMCParams(n_colors=max(4, g.max_degree // 2), proposal=ProposalKind.BALANCE_DYNAMIC,
                   tailcut=True, taboo_iterations=2, max_iterations=60)
    before = (k2.launches, k3.launches)
    c = tm.MCMCColorer(g, p, backend=backend, layout="bucketed", device="cpu")
    r = c.run(seed=7)
    assert (k2.launches, k3.launches) == before
    assert check_coloring(g, r.colors) and r.extra["final_conflicts"] == 0
    assert r.extra["tailcut_rounds"] >= 1 and r.conflict_trace.shape == (r.iterations + 1,)
    # K2 and K3 take rows of any width: classes 8 · 4^k under either backend
    assert {s.d_pad % 8 for s in c.ell.slices} == {0}
    assert min(s.d_pad for s in c.ell.slices) < 128


def test_bucketed_mcmc_skewed_graph(ba):
    """tests/test_mcmc.py:test_bucketed_layout_skewed_graph: valid on the
    BA graph, with far fewer ids gathered a sweep than the flat layout."""
    g = interop.graph_from_jax(ba)
    p = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC)
    for backend in ("pallas", "xla"):
        c = tm.MCMCColorer(g, p, backend=backend, layout="bucketed", device="cpu")
        r = c.run(seed=3)
        assert check_coloring(g, r.colors) and r.extra["final_conflicts"] == 0
        assert len(c.ell.slices) >= 2
    # JAX's measure, on the CPU's (xla) lanes of 8
    assert c.ell.gather_elements < c.ell.n_pad * g.max_degree / 2


def test_bucketed_mcmc_matches_flat_statistically(medium_er):
    """tests/test_mcmc.py:test_bucketed_matches_flat_statistically."""
    g = interop.graph_from_jax(medium_er)
    p = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC)
    flat = [tm.MCMCColorer(g, p, device="cpu").run(seed=s).class_stats()["std"]
            for s in range(3)]
    buck = [tm.MCMCColorer(g, p, layout="bucketed", device="cpu").run(seed=s)
            .class_stats()["std"] for s in range(3)]
    assert abs(np.mean(flat) - np.mean(buck)) < 4 * (np.std(flat) + np.std(buck) + 0.2)


def test_bucketed_hastings_and_refusals(small_er):
    """Hastings runs the generic loop over the layout (the reverse
    probability a class at a time); ``matmul`` and ``packed`` refuse it,
    as JAX's ``backend='matmul'`` does."""
    g = interop.graph_from_jax(small_er)
    p = MCMCParams(n_colors=g.max_degree, hastings=True, lambda_=25.0, tailcut=True,
                   max_iterations=5)
    for backend in ("pallas", "xla"):
        r = tm.MCMCColorer(g, p, backend=backend, layout="bucketed", device="cpu").run(seed=2)
        assert check_coloring(g, r.colors) and r.extra["final_conflicts"] == 0
    for backend in ("matmul", "packed"):
        with pytest.raises(ValueError, match="flat-layout only"):
            tm.MCMCColorer(g, p, backend=backend, layout="bucketed", device="cpu")
    with pytest.raises(ValueError, match="layout"):
        tm.MCMCColorer(g, p, layout="ragged", device="cpu")


def test_bucketed_active_converges_and_matches_flat(medium_er, ba):
    """tests/test_mcmc_active.py:86-122: the frontier chain over the
    layout ends valid with 0 conflicts, on the BA graph with a palette
    that forces the frontier tailcut, and uses as many colours as the flat
    frontier chain within 15 %."""
    g = interop.graph_from_jax(medium_er)
    p = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC,
                   taboo_iterations=2)
    seeds = [2, 9, 27]
    flat = [ta.ActiveMCMCColorer(g, p, device="cpu").run(seed=s) for s in seeds]
    buck = [ta.ActiveMCMCColorer(g, p, layout="bucketed", device="cpu").run(seed=s)
            for s in seeds]
    assert all(r.extra["final_conflicts"] == 0 and check_coloring(g, r.colors) for r in buck)
    fu = np.mean([r.used_colors for r in flat])
    bu = np.mean([r.used_colors for r in buck])
    assert abs(fu - bu) <= 0.15 * max(fu, bu)
    gb = interop.graph_from_jax(ba)
    pb = MCMCParams(n_colors=max(8, gb.max_degree // 4), proposal=ProposalKind.BALANCE_DYNAMIC,
                    tailcut=True)
    r = ta.ActiveMCMCColorer(gb, pb, layout="bucketed", device="cpu").run(seed=11)
    assert r.extra["final_conflicts"] == 0 and check_coloring(gb, r.colors)


def test_bucketed_active_iteration_matches_jax(ba):
    """One frontier iteration over the layout from one state, on JAX's
    draws, against JAX's ``_active_iteration`` (K2 in interpret mode with
    ``self_ids``): colours by the CDF-boundary rule, taboo where they
    agree, and the kept cnt a fresh re-count."""
    jb, tb = layouts(ba, min_lane=128)
    n_colors = 14
    jp = JParams(n_colors=n_colors, proposal=JKind.BALANCE_DYNAMIC, taboo_iterations=2)
    pt = port_params(jp)
    colors, taboo, _ = random_state(jb, n_colors, seed=6)
    cnt = np.asarray(ja._cnt_of(jb, jnp.asarray(colors), params=None))
    n_active = int(((cnt > 0) & (taboo == 0)).sum())
    cap = ta.pick_cap(ta._buckets(jb.n_pad), n_active)
    k_it = jax.random.key(12)
    _, k_u, k_flip, k_fv, k_fc = jax.random.split(k_it, 5)
    draws = [np.array(jax.random.uniform(k_u, (cap,), dtype=jnp.float32)),
             np.array([jax.random.uniform(k_flip, (), dtype=jnp.float32)]),
             np.array([jax.random.randint(k_fv, (), 0, jb.n_pad, dtype=jnp.int32)]),
             np.array([jax.random.randint(k_fc, (), 1, n_colors, dtype=jnp.int32)])]
    cj, tj, _ = ja._active_iteration(jb, jnp.asarray(colors), jnp.asarray(taboo),
                                     jnp.asarray(cnt), k_it, cap=cap, params=jp,
                                     backend="pallas")
    ct, tt, cnt_t, _ = ta._active_iteration(tb, t(colors), t(taboo), t(cnt), Replay(draws),
                                            cap=cap, params=pt, backend="pallas")
    # the frontier's uniforms at its vertices (ascending ids, as
    # frontier_ids takes them) and every row's cdf from this state
    ids = np.flatnonzero((cnt > 0) & (taboo == 0) & np.asarray(jb.node_mask))
    unif_full = np.zeros(jb.n_pad, np.float32)
    unif_full[ids] = draws[0][: ids.size]
    hist = j_hist(jnp.asarray(colors), n_colors, jb.node_mask)
    cdf = jax_cdf_bucketed(jb, jnp.asarray(colors), jp,
                           jm._variant_distribution(jp, hist, jb.n_nodes))
    mism = assert_boundary_only(ct.numpy(), np.asarray(cj), unif_full, cdf, ba.n)
    keep = np.ones(jb.n_pad, bool)
    keep[mism] = False
    assert np.array_equal(tt.numpy()[keep], np.asarray(tj)[keep])
    assert (ct.numpy() != colors).any()
    assert torch.equal(cnt_t, ta._cnt_of(tb, ct))


# ---------------------------------- CLI ----------------------------------


@pytest.mark.parametrize("active", [False, True])
def test_cli_layout_bucketed(tmp_path, active):
    """``--layout bucketed`` runs the four device colorers (with
    ``--active`` too) to valid colourings; JAX's log parser reads the
    logs, and the deterministic colorers' fields and colour files equal
    the JAX CLI's (tests/test_cli_analysis.py:234 runs the same
    composition)."""
    flags = ["--simulate", "0.1", "-n", "150", "--layout", "bucketed", "--seed", "3",
             "--quiet"] + (["--active"] if active else [])
    port = tmp_path / "port"
    rc = cli_main(flags + ["--mcmcgpu", "--lubygpu", "--grdffgpu", "--vffgpu", "--tailcut",
                           "--check", "--outDir", str(port), "--device", "cpu"])
    assert rc == 0
    got = parse_results_dir(str(port))
    assert set(got) == {"MCMC_GPU", "LUBY", "GFF", "VFF"}
    assert jax_main(flags + ["--grdffgpu", "--vffgpu", "--outDir", str(tmp_path / "jax")]) == 0
    want = parse_results_dir(str(tmp_path / "jax"))
    for tag in ("GFF", "VFF"):
        x, y = got[tag][0], want[tag][0]
        for k in y:
            if k not in ("path", "execution_time_s"):
                assert x[k] == y[k], (tag, k)
        name = os.path.basename(y["path"]).replace(".log", "-colors.txt")
        assert np.array_equal(np.loadtxt(port / name), np.loadtxt(tmp_path / "jax" / name))
