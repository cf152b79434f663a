"""The port's frontier GreedyFF and VFF against the JAX package's.

Both colorers are deterministic integer work, so on the same graph the
colours, the colour counts, the rounds and VFF's livelock flag must be
equal exactly (``np.array_equal`` on int32 colours).  The JAX side runs
as its own tests run it on the CPU (``backend="xla"``); K3's plain
version at the frontier call sites is held against JAX's Pallas kernel
``pallas_first_fit`` in interpret mode on the same gathered rows.

``medium_er`` (ER(500, 0.05), seed 3) runs into VFF's livelock fallback
in phase 2 (its flagged set repeats for ten rounds); ``small_er`` does
not, so both branches are covered.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.models import vff as jvff
from mcmc_colorer_tpu.models.greedy_ff import GreedyFFColorer as JGreedyFF
from mcmc_colorer_tpu.models.mcmc_active import _buckets as j_buckets
from mcmc_colorer_tpu.models.mcmc_active import pick_cap as j_pick_cap
from mcmc_colorer_tpu.models.vff import VFFColorer as JVFF
from mcmc_colorer_tpu.ops.neighbor import take_rows as j_take_rows
from mcmc_colorer_tpu.ops.pallas_firstfit import pallas_first_fit

from mcmc_colorer_tpu_torch import interop
from mcmc_colorer_tpu_torch.interop import graph_from_jax
from mcmc_colorer_tpu_torch.models import mcmc_active as tact
from mcmc_colorer_tpu_torch.models import vff as tvff
from mcmc_colorer_tpu_torch.models.base import check_coloring
from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer
from mcmc_colorer_tpu_torch.models.vff import VFFColorer
from mcmc_colorer_tpu_torch.ops import firstfit as k3
from mcmc_colorer_tpu_torch.ops.neighbor import take_rows

torch.set_num_threads(2)

FIXTURES = ["small_er", "medium_er"]


@pytest.mark.parametrize("fixture", FIXTURES)
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_gff_active_matches_jax(request, fixture, backend):
    """Frontier GreedyFF: the same colours and rounds as JAX's frontier
    loop and as the port's own full loop."""
    jg = request.getfixturevalue(fixture)
    g = graph_from_jax(jg)
    want = JGreedyFF(jg, active=True).run()
    got = GreedyFFColorer(g, backend=backend, active=True, device="cpu").run()
    full = GreedyFFColorer(g, backend=backend, device="cpu").run()
    assert got.colors.dtype == np.int32
    assert np.array_equal(got.colors, want.colors)
    assert np.array_equal(got.colors, full.colors)
    assert (got.n_colors, got.iterations) == (want.n_colors, want.iterations)
    assert got.iterations == full.iterations
    assert got.extra == want.extra


def test_gff_active_fine_ladder(medium_er):
    """A ladder of factor 2 switches capacity every round or two."""
    g = graph_from_jax(medium_er)
    want = JGreedyFF(medium_er, active=True, min_bucket=128, bucket_factor=2).run()
    got = GreedyFFColorer(g, active=True, min_bucket=128, bucket_factor=2,
                          device="cpu").run()
    assert np.array_equal(got.colors, want.colors)
    assert check_coloring(g, got.colors)


@pytest.mark.parametrize("n_pad,min_bucket,factor", [
    (128, 128, 4), (1024, 128, 4), (1_000_448, 128, 4), (1_000_448, 128, 16),
    (5000, 1, 2), (5000, 300, 3), (70_000, 129, 1),
])
def test_bucket_ladder_matches_jax(n_pad, min_bucket, factor):
    caps = tact._buckets(n_pad, min_bucket, factor)
    assert caps == j_buckets(n_pad, min_bucket, factor)
    for count in {0, 1, 127, 128, 129, n_pad // 3, n_pad - 1, n_pad}:
        if count > n_pad:
            continue
        assert tact.pick_cap(caps, count) == j_pick_cap(caps, count)


@pytest.mark.parametrize("fixture", FIXTURES)
@pytest.mark.parametrize("active", [False, True])
def test_vff_matches_jax(request, fixture, active):
    """VFF, full and frontier: colours, used colours, rounds and the
    livelock flag equal JAX's; the colouring is valid and inside the
    GreedyFF palette."""
    jg = request.getfixturevalue(fixture)
    g = graph_from_jax(jg)
    want = JVFF(jg, active=active).run()
    got = VFFColorer(g, active=active, device="cpu").run()
    assert np.array_equal(got.colors, want.colors)
    assert (got.n_colors, got.iterations) == (want.n_colors, want.iterations)
    assert got.extra == want.extra
    assert check_coloring(g, got.colors)
    assert int(got.colors.max()) < got.n_colors
    assert got.extra["livelock_fallback"] == (fixture == "medium_er")


def test_vff_backends_agree(medium_er):
    """K3's route (its plain version on the CPU) and the plain route give
    the same VFF, full and frontier, and so do the full and frontier
    loops; also where phase 2 ended, which the livelock fallback
    discards (and which differs from GreedyFF's colours here)."""
    g = graph_from_jax(medium_er)
    gff = GreedyFFColorer(g, device="cpu").run()
    phase2 = []
    for active in (False, True):
        ca = VFFColorer(g, backend="pallas", active=active, device="cpu")
        cb = VFFColorer(g, backend="xla", active=active, device="cpu")
        a, b = ca.run(), cb.run()
        assert np.array_equal(a.colors, b.colors) and a.iterations == b.iterations
        assert a.extra == b.extra == {"livelock_fallback": True}
        assert np.array_equal(a.colors, gff.colors)
        assert np.array_equal(ca.phase2_colors, cb.phase2_colors)
        assert not np.array_equal(ca.phase2_colors, gff.colors)
        phase2.append(ca.phase2_colors)
    assert np.array_equal(*phase2)


def test_vff_balances_small(small_er):
    """Without the fallback the class-size spread must not exceed
    GreedyFF's (tests/test_init_colorers.py:43)."""
    g = graph_from_jax(small_er)
    gff = GreedyFFColorer(g, device="cpu").run()
    for active in (False, True):
        r = VFFColorer(g, active=active, device="cpu").run()
        assert not r.extra["livelock_fallback"]
        assert r.class_stats()["std"] <= gff.class_stats()["std"] + 1e-6


def _first_frontier_round(jg, kind):
    """The frontier rows, colours, allow mask and cur of the first
    frontier round of VFF's phase 2 (``kind="vff"``) or of GreedyFF
    (``"gff"``), computed by the JAX package."""
    jc = JVFF(jg, active=True)
    ell, max_colors = jc.ell, jc.max_colors
    if kind == "gff":
        colors = jnp.where(ell.node_mask, -1, max_colors).astype(jnp.int32)
        mask = (colors < 0) & ell.node_mask
        cap = j_pick_cap(j_buckets(ell.n_pad), int(mask.sum()))
        pal = min(max_colors, ell.d_pad + 1)
        return ell, colors, mask, cap, jnp.ones((pal,), jnp.int32), None, pal
    gff_colors, _ = JGreedyFF(jg, active=True, ell=ell)._run_active()
    n_used = int(jnp.max(jnp.where(ell.node_mask, gff_colors, -1))) + 1
    gamma = jg.n // n_used
    bins, unb = jvff._vff_detect(ell, gff_colors, max_colors, gamma)
    allow = (bins < gamma) & (jnp.arange(max_colors) < n_used)
    cap = j_pick_cap(j_buckets(ell.n_pad), int(unb.sum()))
    return ell, gff_colors, unb, cap, allow.astype(jnp.int32), True, max_colors


@pytest.mark.parametrize("kind", ["vff", "gff"])
def test_k3_plain_at_frontier_call(medium_er, kind):
    """K3's plain version on the frontier rows of VFF's ``allow``/``cur``
    call (vff.py:287) and of GreedyFF's cut palette (greedy_ff.py:316)
    equals ``pallas_first_fit`` (interpret mode) on ``ext[rows]``."""
    ell, colors, mask, cap, allow, with_cur, n_colors = _first_frontier_round(medium_er, kind)
    (ids,) = jnp.nonzero(mask, size=cap, fill_value=ell.n_pad)
    valid = ids < ell.n_pad
    rows = j_take_rows(ell, ids, valid)
    ext = jnp.concatenate([colors, jnp.full((1,), -1, jnp.int32)])
    cur = jnp.where(valid, colors[jnp.minimum(ids, ell.n_pad - 1)], n_colors) if with_cur else None
    want = np.asarray(pallas_first_fit(ext[rows], allow, n_colors=n_colors, block=128,
                                       interpret=True, cur=cur))
    got = k3.first_fit_plain(
        torch.from_numpy(np.array(rows)), torch.from_numpy(np.array(colors)),
        torch.from_numpy(np.array(allow)), n_colors,
        None if cur is None else torch.from_numpy(np.array(cur)),
    ).numpy()
    assert np.array_equal(got, want)
    assert (got[np.asarray(valid)] >= 0).any()


def test_unported_layouts_raise(small_er, monkeypatch):
    """The bucketed layout, once refused, runs: bucketed VFF equals JAX's,
    and the frontier's rows gathered from its classes equal JAX's
    ``take_rows``; an unknown layout raises."""
    g = graph_from_jax(small_er)
    want = JVFF(small_er, layout="bucketed", backend="xla").run()
    got = VFFColorer(g, layout="bucketed", backend="xla", device="cpu").run()
    assert np.array_equal(got.colors, want.colors) and check_coloring(g, got.colors)
    with pytest.raises(ValueError, match="layout"):
        VFFColorer(g, layout="ragged", device="cpu")
    jc = JVFF(small_er, layout="bucketed", backend="xla")
    ids = jnp.asarray(np.r_[np.arange(0, jc.ell.n_pad, 3), [jc.ell.n_pad] * 5].astype(np.int32))
    valid = ids < jc.ell.n_pad
    rows = take_rows(interop.bucketed_from_jax(jc.ell), torch.from_numpy(np.array(ids)),
                     torch.from_numpy(np.array(valid)))
    assert np.array_equal(rows.numpy(), np.asarray(j_take_rows(jc.ell, ids, valid)))
    # without a card the colorers refuse unless asked for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (VFFColorer, lambda g: GreedyFFColorer(g, active=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(g)


def test_vff_phase2_history_ring():
    """The livelock test of the in-place ring fires on the same round as
    JAX's rolled ring, for flagged sets that settle after k rounds."""
    n = 16
    rng = np.random.default_rng(0)
    for settle in (0, 3, 9, 10, 14):
        sets = [rng.random(n) < 0.5 for _ in range(settle)] + [np.arange(n) % 3 == 0] * 12
        hist_j = jnp.zeros((tvff._UNBALANCED_HISTORY, n), jnp.bool_)
        hist_t = torch.zeros((tvff._UNBALANCED_HISTORY, n), dtype=torch.bool)
        fired_j = fired_t = None
        for r, s in enumerate(sets):
            hist_j = jnp.roll(hist_j, 1, axis=0).at[0].set(jnp.asarray(s))
            if fired_j is None and r + 1 >= 10 and bool(jnp.all(hist_j == hist_j[0:1])):
                fired_j = r
            if fired_t is None and tvff._push_history(hist_t, r, torch.from_numpy(s)):
                fired_t = r
        assert fired_t == fired_j is not None
