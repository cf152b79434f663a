"""The port's frontier (active-set) MCMC chain against the JAX package's
(``mcmc_colorer_tpu/models/mcmc_active.py``), on the CPU.

- Teacher-forced pieces: from one numpy-made state, JAX's function runs
  on a key and the port's on the draws JAX made from that key (replayed
  in ``utils/rng.py``'s order).  ``_tailcut_round``, the tailcut loop,
  ``_cnt_of`` and ``_cnt_of_packed`` are integer work: exact.  The
  iterations sample from a float32 CDF that XLA and torch add in
  different orders, so colours must be equal except at CDF-boundary
  vertices (the rule of ``tests/test_torch_sweep.py``: within 1e-5 of
  JAX's cdf at JAX's colour or the one before, at most 0.1 % of them);
  the taboo must be equal where the colours agree, ``cnt`` must equal a
  fresh re-count, and JAX's ``cnt`` where no colour differs.
- K2's ``self_ids`` form: its plain version against JAX's
  ``pallas_sweep(..., self_ids=...)`` in interpret mode, conflicts exact.
- Whole runs (the port's own draws): valid, the switch cadence, the
  statistics of the full chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.config import MCMCParams as JParams
from mcmc_colorer_tpu.config import ProposalKind as JKind
from mcmc_colorer_tpu.graph.generate import erdos_renyi as j_er
from mcmc_colorer_tpu.models import mcmc_active as ja
from mcmc_colorer_tpu.models import mcmc as jm
from mcmc_colorer_tpu.ops.neighbor import color_histogram as j_hist
from mcmc_colorer_tpu.ops.neighbor import neighbor_colors as j_nc
from mcmc_colorer_tpu.ops.neighbor import occupancy_matrix as j_occ
from mcmc_colorer_tpu.ops.neighbor import take_rows as j_take_rows
from mcmc_colorer_tpu.ops.pallas_resample import pallas_sweep

from mcmc_colorer_tpu_torch import interop
from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.models import mcmc_active as ta
from mcmc_colorer_tpu_torch.models.base import check_coloring
from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
from mcmc_colorer_tpu_torch.ops import resample as k2
from mcmc_colorer_tpu_torch.utils.rng import TorchUniformSource

from test_torch_mcmc import jax_cdf, port_params
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
        assert r.shape == (n,) and r.dtype == np.int32, (r.shape, n)
        assert low <= r.min() and r.max() < high
        return torch.from_numpy(r)


class Recorder(TorchUniformSource):
    """The port's own source, recording each draw's kind and size."""

    def __init__(self, seed):
        super().__init__(seed, 0, "cpu")
        self.log = []

    def next(self, n):
        self.log.append(("next", n))
        return super().next(n)

    def randint(self, n, high, low=0):
        self.log.append(("randint", n))
        return super().randint(n, high, low)


def t(x):
    return torch.from_numpy(np.array(x))


def active_draws(k_it, cap, n_pad, n_colors):
    """JAX's draws of one frontier iteration (mcmc_active.py:401-466)."""
    _, k_u, k_flip, k_fv, k_fc = jax.random.split(k_it, 5)
    return [
        np.array(jax.random.uniform(k_u, (cap,), dtype=jnp.float32)),
        np.array([jax.random.uniform(k_flip, (), dtype=jnp.float32)]),
        np.array([jax.random.randint(k_fv, (), 0, n_pad, dtype=jnp.int32)]),
        np.array([jax.random.randint(k_fc, (), 1, max(n_colors, 2), dtype=jnp.int32)]),
    ]


def flip_happens(draws, cnt, taboo, mask, n_colors, eps):
    """JAX's ε-flip decision for these draws (mcmc_active.py:454-462)."""
    elig = (cnt <= 0) & (taboo == 0) & mask
    p_any = 1.0 - np.exp(np.float32(elig.sum()) * np.log1p(-np.float32((n_colors - 1) * eps)))
    return bool(draws[1][0] < p_any and elig[int(draws[2][0])])


def frontier_state(jg, n_colors, seed, pad=128, last_conflicts=False):
    """(JAX ELL, port ELL, colours, taboo, cnt by JAX): random colours in
    a tight palette, taboo counters in {0, 1, 2}."""
    je = jg.to_ell(pad_nodes_to=pad)
    te = interop.graph_from_jax(jg).to_ell(pad_nodes_to=pad, device="cpu")
    rng = np.random.default_rng(seed)
    colors = rng.integers(0, n_colors, je.n_pad).astype(np.int32)
    colors[jg.n:] = n_colors
    if last_conflicts:  # vertex n - 1 takes a neighbour's colour
        colors[jg.n - 1] = colors[jg.neighbors_of(jg.n - 1)[0]]
    taboo = rng.integers(0, 3, je.n_pad).astype(np.int32)
    taboo[jg.n:] = 0
    if last_conflicts:
        taboo[jg.n - 1] = 0
    cnt = np.asarray(ja._cnt_of(je, jnp.asarray(colors), params=None))
    return je, te, colors, taboo, cnt


def check_iteration(got, want, colors0, unif_full, cdf, n, te, taboo_skip=()):
    """The teacher-forced rule for one iteration's (colors, taboo, cnt)."""
    gc, gt, gcnt = (x.numpy() for x in got[:3])
    wc, wt, wcnt = (np.asarray(x) for x in want)
    mism = assert_boundary_only(gc, wc, unif_full, cdf, n)
    keep = np.ones(gc.shape[0], bool)
    keep[mism] = False
    keep[list(taboo_skip)] = False
    assert np.array_equal(gt[keep], wt[keep])
    assert np.array_equal(gcnt, ta._cnt_of(te, got[0]).numpy())  # a fresh re-count
    if mism.size == 0:
        skip = np.zeros_like(keep)
        skip[list(taboo_skip)] = True
        assert np.array_equal(gcnt[~skip], wcnt[~skip])
    assert tuple(got[3]) == tuple(ta._stats(got[2], got[1]).tolist())
    return mism


ITER_CASES = {
    "no_flip": dict(epsilon=1e-8),
    "flip": dict(epsilon=1e-2),
}


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("case", list(ITER_CASES))
def test_active_iteration_matches_jax(medium_er, case, backend):
    """One frontier iteration from JAX's state on JAX's draws; in the
    "flip" case the key is one whose replayed draws flip a vertex."""
    n_colors = medium_er.max_degree // 2
    jp = JParams(n_colors=n_colors, proposal=JKind.BALANCE_DYNAMIC, taboo_iterations=2,
                 **ITER_CASES[case])
    pt = port_params(jp)
    je, te, colors, taboo, cnt = frontier_state(medium_er, n_colors, seed=3)
    mask = np.arange(je.n_pad) < medium_er.n
    n_active = int(((cnt > 0) & (taboo == 0) & mask).sum())
    cap = ja.pick_cap(ja._buckets(je.n_pad), n_active)
    assert 0 < n_active < cap
    flip = case == "flip"
    for s in range(100):
        k_it = jax.random.key(s)
        draws = active_draws(k_it, cap, je.n_pad, n_colors)
        if flip_happens(draws, cnt, taboo, mask, n_colors, jp.epsilon) == flip:
            break
    else:
        raise AssertionError(f"no key with flip={flip}")
    want = ja._active_iteration(je, jnp.asarray(colors), jnp.asarray(taboo), jnp.asarray(cnt),
                                k_it, cap=cap, params=jp, backend="xla")
    src = Replay(draws)
    before = k2.launches
    got = ta._active_iteration(te, t(colors), t(taboo), t(cnt), src, cap=cap, params=pt,
                               backend=backend)
    assert not src.draws and k2.launches == before  # CPU: K2's plain version
    ids = np.flatnonzero((cnt > 0) & (taboo == 0) & mask)
    unif_full = np.zeros(je.n_pad, np.float32)
    unif_full[ids] = draws[0][: ids.size]
    cdf = jax_cdf(je, jnp.asarray(colors), jp)
    check_iteration(got, want, colors, unif_full, cdf, medium_er.n, te)
    fv = int(draws[2][0])
    moved = got[0].numpy() != colors
    assert moved[fv] == flip and moved[ids].any() and not moved[np.setdiff1d(
        np.arange(je.n_pad), np.append(ids, fv))].any()
    if flip:  # the flipped vertex: JAX's colour, taboo 0
        assert int(got[0][fv]) == int(want[0][fv]) and int(got[1][fv]) == 0


def test_active_iteration_flip_beside_the_frontier(medium_er):
    """The ε-flip's cnt update (the flipped vertex's row, after the
    frontier's), forced by the draws: the flipped vertex neighbours a
    frontier vertex and takes the colour of a neighbour that stays put,
    so counts on both sides change.  cnt must equal a fresh re-count."""
    n_colors = medium_er.max_degree // 2
    pt = port_params(JParams(n_colors=n_colors, proposal=JKind.BALANCE_DYNAMIC,
                             taboo_iterations=2))
    je, te, colors, taboo, cnt = frontier_state(medium_er, n_colors, seed=3)
    mask = np.arange(je.n_pad) < medium_er.n
    front = (cnt > 0) & (taboo == 0) & mask
    elig = (cnt <= 0) & (taboo == 0) & mask
    neigh = te.neighbors.numpy()
    fv, stay = next((v, u) for v in np.flatnonzero(elig)
                    if front[(row := neigh[v][neigh[v] < je.n_pad])].any()
                    for u in row if not front[u] and u != v)
    offs = (colors[stay] - colors[fv]) % n_colors
    cap = ta.pick_cap(ta._buckets(je.n_pad), int(front.sum()))
    rng = np.random.default_rng(5)
    draws = [rng.random(cap, dtype=np.float32), np.zeros(1, np.float32),
             np.array([fv], np.int32), np.array([offs], np.int32)]
    got = ta._active_iteration(te, t(colors), t(taboo), t(cnt), Replay(draws), cap=cap,
                               params=pt, backend="xla")
    assert int(got[0][fv]) == colors[stay] == int(got[0][stay]) and int(got[1][fv]) == 0
    assert np.array_equal(got[2].numpy(), ta._cnt_of(te, got[0]).numpy())
    assert int(got[2][fv]) >= 1 and int(got[2][stay]) >= 1
    assert tuple(got[3]) == tuple(ta._stats(got[2], got[1]).tolist())


def test_active_iteration_at_n_equal_n_pad():
    """n == n_pad (ER(640, 0.05) padded to 128) with vertex n_pad - 1 in
    the frontier and a cap above the frontier's size.  JAX's scatters
    through ids clamped to n_pad - 1 (mcmc_active.py:476-479, 503-506)
    write that vertex's stale taboo and count over its own; the port
    writes the valid rows only.  Its cnt must equal a fresh re-count and
    its taboo must follow the rule; every other vertex agrees with JAX."""
    jg = j_er(640, 0.05, seed=3)
    n_colors = jg.max_degree // 2
    jp = JParams(n_colors=n_colors, proposal=JKind.BALANCE_DYNAMIC, taboo_iterations=2)
    pt = port_params(jp)
    je, te, colors, taboo, cnt = frontier_state(jg, n_colors, seed=1, last_conflicts=True)
    last = jg.n - 1
    assert je.n_pad == jg.n and cnt[last] > 0
    cap = je.n_pad
    k_it = jax.random.key(0)
    draws = active_draws(k_it, cap, je.n_pad, n_colors)
    want = ja._active_iteration(je, jnp.asarray(colors), jnp.asarray(taboo), jnp.asarray(cnt),
                                k_it, cap=cap, params=jp, backend="xla")
    got = ta._active_iteration(te, t(colors), t(taboo), t(cnt), Replay(draws), cap=cap,
                               params=pt, backend="xla")
    mask = np.arange(je.n_pad) < jg.n
    ids = np.flatnonzero((cnt > 0) & (taboo == 0) & mask)
    assert ids[-1] == last and ids.size < cap
    unif_full = np.zeros(je.n_pad, np.float32)
    unif_full[ids] = draws[0][: ids.size]
    cdf = jax_cdf(je, jnp.asarray(colors), jp)
    mism = check_iteration(got, want, colors, unif_full, cdf, jg.n, te, taboo_skip=[last])
    assert last not in mism
    moved = int(got[0][last]) != colors[last]
    assert int(got[1][last]) == (0 if moved else jp.taboo_iterations)
    # JAX's count of vertex n_pad - 1 is not a re-count of its colouring
    fresh = np.asarray(ja._cnt_of(je, want[0], params=jp))
    assert moved and int(want[2][last]) != fresh[last]
    assert int(want[1][last]) == jp.taboo_iterations  # re-armed, though it moved


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_full_iteration_matches_jax(medium_er, backend):
    jp = JParams(n_colors=medium_er.max_degree // 2, proposal=JKind.BALANCE_DYNAMIC,
                 taboo_iterations=2)
    pt = port_params(jp)
    je, te, colors, taboo, _ = frontier_state(medium_er, jp.n_colors, seed=4)
    key = jax.random.key(9)
    _, k_u = jax.random.split(key)
    unif = np.array(jax.random.uniform(k_u, (je.n_pad,), dtype=jnp.float32))
    star_j, taboo_j, conf_j = ja._full_iteration(
        je, jnp.asarray(colors), jnp.asarray(taboo), key, params=jp, block=128, backend="xla")
    star_t, taboo_t, conf_t = ta._full_iteration(te, t(colors), t(taboo), Replay([unif]),
                                                 params=pt, block=128, backend=backend)
    assert int(conf_t) == int(conf_j)
    mism = assert_boundary_only(star_t.numpy(), np.asarray(star_j), unif,
                                jax_cdf(je, jnp.asarray(colors), jp), medium_er.n)
    keep = np.ones(je.n_pad, bool)
    keep[mism] = False
    assert np.array_equal(taboo_t.numpy()[keep], np.asarray(taboo_j)[keep])


@pytest.mark.parametrize("n_colors", [None, 3], ids=["movable", "stalled"])
def test_tailcut_round_matches_jax(medium_er, n_colors):
    """Three frontier tailcut rounds on JAX's randint draws: colours and
    cnt exact.  With 3 colours no conflicting vertex has a free colour,
    so the stall escape runs."""
    n_colors = n_colors or medium_er.max_degree // 2
    jp = JParams(n_colors=n_colors, proposal=JKind.BALANCE_DYNAMIC, tailcut=True)
    pt = port_params(jp)
    je, te, colors, _, cnt = frontier_state(medium_er, n_colors, seed=6)
    mask = je.node_mask
    hist = jnp.bincount(jnp.where(mask, jnp.asarray(colors), n_colors), length=n_colors + 1)
    ordered = np.asarray(jnp.argsort(hist[:n_colors])).astype(np.int32)
    cj, cntj = jnp.asarray(colors), jnp.asarray(cnt)
    ct, cntt = t(colors), t(cnt)
    for r in range(3):
        n_flag = int((np.asarray(cntj) > 0).sum())
        cap = ja.pick_cap(ja._buckets(je.n_pad), n_flag)
        key = jax.random.key(r)
        rnd = np.array(jax.random.randint(key, (cap,), 0, n_colors, dtype=jnp.int32))
        cj, cntj = ja._tailcut_round(je, cj, cntj, jnp.asarray(ordered), key, cap=cap,
                                     params=jp)
        ct, cntt = ta._tailcut_round(te, ct, cntt, t(ordered), Replay([rnd]), cap=cap,
                                     params=pt)
        assert np.array_equal(ct.numpy(), np.asarray(cj))
        assert np.array_equal(cntt.numpy(), np.asarray(cntj))
    if n_colors == 3:
        assert not np.array_equal(ct.numpy(), colors)  # the escape moved someone


class JaxTailcutKeys:
    """JAX's tailcut draws: ``key, k_r = split(key)`` a round
    (mcmc_active.py:204), then ``randint(k_r, (cap,), 0, nCol)``."""

    def __init__(self, key):
        self.key = key

    def randint(self, n, high, low=0):
        self.key, k_r = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.randint(k_r, (n,), low, high,
                                                            dtype=jnp.int32)))


def test_tailcut_loop_matches_jax(medium_er):
    """The whole frontier tailcut (``_tailcut_active``) on JAX's keys:
    colours, cnt, conflicts and rounds exact."""
    n_colors = medium_er.max_degree // 2
    jp = JParams(n_colors=n_colors, proposal=JKind.BALANCE_DYNAMIC, tailcut=True)
    jc = ja.ActiveMCMCColorer(medium_er, jp)
    tc = ta.ActiveMCMCColorer(interop.graph_from_jax(medium_er), port_params(jp),
                              device="cpu")
    assert tc.ell.n_pad == jc.ell.n_pad and tc._caps == ja._buckets(jc.ell.n_pad)
    _, _, colors, _, cnt = frontier_state(medium_er, n_colors, seed=8, pad=jc.ell.n_pad)
    key = jax.random.key(12)
    cj, cntj, conf_j, rounds_j = jc._tailcut_active(jnp.asarray(colors), jnp.asarray(cnt), key)
    ct, cntt, conf_t, rounds_t = ta._tailcut_active(
        tc.ell, t(colors), t(cnt), JaxTailcutKeys(key), params=tc.params, caps=tc._caps)
    assert np.array_equal(ct.numpy(), np.asarray(cj))
    assert np.array_equal(cntt.numpy(), np.asarray(cntj))
    assert (conf_t, rounds_t) == (conf_j, rounds_j) and conf_t == 0 and rounds_t > 1


def test_cnt_of_matches_jax(medium_er):
    """``_cnt_of`` (row bands) and ``_cnt_of_packed`` (K1's plain version
    over the packed A built from the ELL) equal JAX's, exactly."""
    from mcmc_colorer_tpu.ops.dense_adj import build_packed_adjacency
    from mcmc_colorer_tpu_torch.ops.dense_adj import get_adjacency

    n_colors = medium_er.max_degree // 2
    je, te, colors, _, cnt = frontier_state(medium_er, n_colors, seed=2)
    jp = JParams(n_colors=n_colors)
    assert np.array_equal(ta._cnt_of(te, t(colors)).numpy(), cnt)
    adj_j = build_packed_adjacency(medium_er, je.n_pad)
    want = np.asarray(ja._cnt_of_packed(adj_j, jnp.asarray(colors), params=jp,
                                        node_mask=je.node_mask))
    g = interop.graph_from_jax(medium_er)
    adj_t = get_adjacency(g, te)
    got = ta._cnt_of_packed(adj_t, t(colors), params=port_params(jp), node_mask=te.node_mask)
    assert np.array_equal(got.numpy(), want) and np.array_equal(want, cnt)


@pytest.mark.parametrize("kind", [ProposalKind.STANDARD, ProposalKind.BALANCE_DYNAMIC,
                                  ProposalKind.DECREASE_EXP])
def test_k2_self_ids_matches_pallas_sweep(medium_er, kind):
    """K2's plain version on a frontier's rows with their own ids as
    ``self_ids`` against JAX's kernel (interpret mode) fed the gathered
    colours of the same rows: conflicts exact, samples under the CDF
    boundary rule, taboo where the samples agree."""
    n_colors = medium_er.max_degree // 2
    jp = JParams(n_colors=n_colors, proposal=JKind(kind.value), taboo_iterations=2,
                 epsilon=1e-4)
    pt = port_params(jp)
    je, te, colors, _, _ = frontier_state(medium_er, n_colors, seed=5)
    rng = np.random.default_rng(5)
    cap = 256
    ids = np.sort(rng.choice(medium_er.n, 200, replace=False)).astype(np.int32)
    ids = np.concatenate([ids, np.full(cap - ids.size, je.n_pad, np.int32)])
    valid = ids < je.n_pad
    rows = np.asarray(j_take_rows(je, jnp.asarray(ids), jnp.asarray(valid)))
    cur = np.where(valid, colors[np.minimum(ids, je.n_pad - 1)], n_colors).astype(np.int32)
    taboo = np.zeros(cap, np.int32)
    unif = rng.random(cap, dtype=np.float32)
    p_eff = jm._variant_distribution(
        jp, j_hist(jnp.asarray(colors), n_colors, je.node_mask), medium_er.n)
    p_eff = np.zeros(n_colors, np.float32) if p_eff is None else np.asarray(p_eff, np.float32)
    nc = j_nc(jnp.asarray(rows), jnp.asarray(colors))
    star_j, qstar_j, taboo_j, conf_j = pallas_sweep(
        nc, jnp.asarray(rows), jnp.asarray(cur), jnp.asarray(taboo), jnp.asarray(unif),
        jnp.asarray(p_eff), jnp.float32(jp.epsilon), params=jp, block=128, interpret=True,
        self_ids=jnp.asarray(ids))
    star_t, qstar_t, taboo_t, conf_t = k2.resample_sweep(
        t(rows), t(colors[: medium_er.n]), t(cur), t(taboo), 0, t(unif), t(p_eff),
        jp.epsilon, pt, self_ids=t(ids))
    assert int(conf_t) == int(conf_j) > 0
    # a row offset in place of self_ids counts other conflicts
    assert int(k2.resample_sweep(t(rows), t(colors[: medium_er.n]), t(cur), t(taboo), 0,
                                 t(unif), t(p_eff), jp.epsilon, pt)[3]) != int(conf_j)
    occ = j_occ(nc, n_colors)
    q = jm._proposal_q(jnp.asarray(cur), occ, jp, jnp.asarray(p_eff),
                       eps=jnp.float32(jp.epsilon))
    cdf = np.asarray(jnp.cumsum(q, axis=1))
    sj = np.asarray(star_j)
    mism = assert_boundary_only(star_t.numpy()[valid], sj[valid], unif[valid], cdf[valid],
                                int(valid.sum()))
    keep = np.ones(int(valid.sum()), bool)
    keep[mism] = False
    assert np.array_equal(taboo_t.numpy()[valid][keep], np.asarray(taboo_j)[valid][keep])
    np.testing.assert_allclose(qstar_t.numpy()[valid][keep], np.asarray(qstar_j)[valid][keep],
                               rtol=1e-5)


# ------------------------------ whole runs ------------------------------


def _params(g, **kw):
    return MCMCParams(n_colors=g.max_degree, **kw)


@pytest.mark.parametrize("kind", [ProposalKind.STANDARD, ProposalKind.BALANCE_DYNAMIC])
def test_active_converges_and_valid(medium_er, kind):
    """Mirrors tests/test_mcmc_active.py:test_active_converges_and_valid."""
    g = interop.graph_from_jax(medium_er)
    before = k2.launches
    r = ta.ActiveMCMCColorer(g, _params(g, proposal=kind, taboo_iterations=2),
                             device="cpu").run(seed=7)
    assert k2.launches == before
    assert r.extra["final_conflicts"] == 0
    assert check_coloring(g, r.colors)
    assert r.conflict_trace[-1] == 0
    assert r.conflict_trace[0] >= r.conflict_trace[-1]


def test_active_cnt_invariant(medium_er):
    """The kept cnt at the end of a chain that ran frontier iterations
    equals a fresh re-count, and JAX's ``_cnt_of`` of its colours."""
    g = interop.graph_from_jax(medium_er)
    # 11 colours: frontier iterations run and conflicts remain after 40
    p = MCMCParams(n_colors=11, taboo_iterations=1, max_iterations=40)
    c = ta.ActiveMCMCColorer(g, p, device="cpu")
    ch = c._chain(TorchUniformSource(3, 0, "cpu"))
    assert ch.switch_iteration is not None and sum(ch.frontier_iterations.values()) > 0
    fresh = ta._cnt_of(c.ell, ch.colors)
    assert torch.equal(ch.cnt, fresh) and int(fresh.sum()) // 2 == ch.conflicts > 0
    je = medium_er.to_ell(pad_nodes_to=c.ell.n_pad)
    want = np.asarray(ja._cnt_of(je, jnp.asarray(ch.colors.numpy()), params=None))
    assert np.array_equal(fresh.numpy(), want)


def test_active_matches_full_statistically(medium_er):
    """Mirrors test_active_matches_full_statistically, against the port's
    own MCMCColorer."""
    g = interop.graph_from_jax(medium_er)
    p = _params(g)
    seeds = [2, 9, 27]
    full = [MCMCColorer(g, p, device="cpu").run(seed=s) for s in seeds]
    act = [ta.ActiveMCMCColorer(g, p, device="cpu").run(seed=s) for s in seeds]
    fu = np.mean([r.used_colors for r in full])
    au = np.mean([r.used_colors for r in act])
    assert abs(fu - au) <= 0.15 * max(fu, au)
    assert all(r.extra["final_conflicts"] == 0 for r in act)


def test_active_with_tailcut_small_palette(medium_er):
    g = interop.graph_from_jax(medium_er)
    p = MCMCParams(n_colors=max(4, medium_er.max_degree // 2),
                   proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    r = ta.ActiveMCMCColorer(g, p, device="cpu").run(seed=13)
    assert check_coloring(g, r.colors) and r.extra["final_conflicts"] == 0
    assert r.extra["tailcut_rounds"] >= 1


def test_switch_cadence(medium_er):
    """Full sweeps until 2·conflicts < n_pad // 8, tested on the conflicts
    each sweep measured (those of the colouring it started from), then
    frontier iterations; the draws in ``utils/rng.py``'s order."""
    g = interop.graph_from_jax(medium_er)
    p = MCMCParams(n_colors=11, taboo_iterations=1, max_iterations=30)
    c = ta.ActiveMCMCColorer(g, p, device="cpu")
    src = Recorder(5)
    r = c.run(seed=5, source=src)
    n_pad, x = c.ell.n_pad, r.extra
    switch, trace = x["switch_iteration"], r.conflict_trace
    assert switch is not None and x["full_sweeps"] == switch
    assert all(2 * v >= n_pad // 8 for v in trace[: switch - 1])
    assert 2 * trace[switch - 1] < n_pad // 8
    frontier = sum(x["frontier_iterations"].values())
    assert frontier > 0 and r.iterations == switch + frontier <= p.max_iterations
    assert src.log[: switch + 1] == [("next", n_pad)] * (switch + 1)
    rest = src.log[switch + 1:]
    assert len(rest) == 4 * frontier
    caps = [n for kind, n in rest[0::4]]
    assert sorted(caps) == sorted(k for k, v in x["frontier_iterations"].items()
                                  for _ in range(v))
    assert all(rest[4 * i + 1:4 * i + 4] == [("next", 1), ("randint", 1), ("randint", 1)]
               for i in range(frontier))
    assert len(trace) == switch + frontier + 1 and trace[-1] == x["final_conflicts"]


def test_active_rejects_hastings_and_bucketed(small_er):
    g = interop.graph_from_jax(small_er)
    with pytest.raises(NotImplementedError, match="always-accept"):
        ta.ActiveMCMCColorer(g, _params(g, hastings=True), device="cpu")
    # the bucketed layout is ported: it runs to a valid colouring
    r = ta.ActiveMCMCColorer(g, _params(g, tailcut=True), layout="bucketed",
                             device="cpu").run(seed=3)
    assert r.extra["final_conflicts"] == 0 and check_coloring(g, r.colors)
    with pytest.raises(ValueError, match="layout"):
        ta.ActiveMCMCColorer(g, _params(g), layout="ragged", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        ta.ActiveMCMCColorer(g, _params(g), backend="matmul", device="cpu")


def test_bucket_ladder_rounds_to_tile_multiples():
    """Mirrors tests/test_mcmc_active.py:test_bucket_ladder_rounds_to_tile_multiples."""
    caps = ta._buckets(4096, min_bucket=100, factor=4)
    assert caps == ja._buckets(4096, min_bucket=100, factor=4)
    assert all(c % 128 == 0 for c in caps) and caps[-1] == 4096
    assert ta.pick_cap(caps, 1) == caps[0]
    assert ta.pick_cap(caps, 4000) == 4096
