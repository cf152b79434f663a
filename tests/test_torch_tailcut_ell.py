"""The ELL tailcut's round, factored into K3's tailcut call and the
lower-movable pass, against the round it factors, on the CPU.

``_tailcut_body`` runs its two passes through ``ops/firstfit.first_fit``
with ``flag`` (first fit, conflict flag and conflict count from one
gather) and ``lower_movable``; on CPU tensors both are their plain
versions, in row bands.  ``unfactored_round`` below is the round as it
stood before: the conflict flag and count from one gather, K3's greedy
call over a second, and the lower-movable test over every slot.  The
two must give the same colours, conflicts, rounds and exit flags on
every round, with a chain axis (one chain not running), over the flat
and the degree-bucketed layouts, in one band and in many, with and
without the stall escape.  The pieces are held alone too: the tailcut
call's outputs (at ``row0`` > 0, on phantom and padding rows) and the
lower-movable pass against their formulas, and the calls' refusals.
JAX's own round is held in ``test_torch_mcmc.py`` and
``test_torch_bucketed.py``.
"""

import numpy as np
import pytest
import torch

from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.graph.generate import barabasi_albert, erdos_renyi
from mcmc_colorer_tpu_torch.models import mcmc as tm
from mcmc_colorer_tpu_torch.ops import firstfit as k3
from mcmc_colorer_tpu_torch.ops.neighbor import neighbor_colors_chains
from mcmc_colorer_tpu_torch.utils.rng import ChainSources, TorchUniformSource

torch.set_num_threads(2)

CHAINS = 3
RUNNING = np.array([True, False, True])


def unfactored_round(ell, tc, running, sources, *, params):
    """The round before it was factored: pass 1 gathers the neighbours'
    colours for the flag and count, K3's greedy call gathers them again,
    pass 2 gathers every slot's movable flag."""
    cols_r = tc.colors_r
    c, n_pad = cols_r.shape
    n_colors = params.n_colors
    ids = torch.arange(n_pad, dtype=torch.int32)
    allow = torch.ones((n_colors,), dtype=torch.int32)
    conf = torch.zeros((c,), dtype=torch.int64)
    flags = torch.empty((c, n_pad), dtype=torch.bool)
    cand = torch.empty((c, n_pad), dtype=torch.int32)
    for s, neigh in tm._row_blocks(ell, chains=c):
        e = s + neigh.shape[0]
        same = neighbor_colors_chains(neigh, cols_r) == cols_r[:, s:e, None]
        conf += (same & (neigh > ids[s:e, None])[None]).sum((1, 2))
        flags[:, s:e] = same.any(2)
        cand[:, s:e] = k3.first_fit(neigh, cols_r, allow, n_colors)
    flags &= ell.node_mask
    cand = torch.where(ell.node_mask, cand, -1)
    movable = flags & (cand >= 0)
    movable_ext = torch.cat([movable, torch.zeros((c, 1), dtype=torch.bool)], 1)
    lower = torch.empty((c, n_pad), dtype=torch.bool)
    for s, neigh in tm._row_blocks(ell, chains=c):
        e = s + neigh.shape[0]
        nb = movable_ext.index_select(1, neigh.reshape(-1)).reshape(c, *neigh.shape)
        lower[:, s:e] = (nb & (neigh < ids[s:e, None])[None]).any(2)
    active = movable & ~lower
    stalled = (conf > 0) & ~active.any(1)
    rnd = sources.randint(n_pad, n_colors, running=running)
    new_r = torch.where(active, cand, torch.where(stalled[:, None] & flags, rnd, cols_r))
    conf_h = conf.numpy()
    return tm.TailcutState(tm._select(running, new_r, cols_r),
                           np.where(running, conf_h, tc.conflicts), tc.rounds + running,
                           tc.done | (running & (conf_h == 0)))


def _ell(layout, n_colors):
    """ER(600, 0.05) laid out flat, or BA(2000, 20) degree-bucketed (two
    classes, the second from 2048 on, with phantom rows), by the
    colourer: degrees of 20 and more."""
    g = erdos_renyi(600, 0.05, seed=11) if layout == "flat" else barabasi_albert(2000, 20, seed=4)
    p = MCMCParams(n_colors=n_colors, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    return tm.MCMCColorer(g, p, layout=layout, device="cpu").ell, p


def _start(ell, n_colors, seed):
    gen = torch.Generator().manual_seed(seed)
    colors = torch.randint(0, n_colors, (CHAINS, ell.n_pad), generator=gen, dtype=torch.int32)
    return torch.where(ell.node_mask, colors, n_colors)


class _Sources(ChainSources):
    """The chains' sources, keeping the round's last random colours."""

    def randint(self, n, high, low=0, running=None):
        self.last = super().randint(n, high, low, running)
        return self.last


def _sources(seed):
    return _Sources([TorchUniformSource(seed, 0, "cpu", chain=k) for k in range(CHAINS)], "cpu")


@pytest.mark.parametrize("bands", ["one", "many"])
@pytest.mark.parametrize("n_colors", [10, 2], ids=["movable", "stalled"])
@pytest.mark.parametrize("layout", ["flat", "bucketed"])
def test_factored_round_is_the_unfactored_round(layout, n_colors, bands, monkeypatch):
    """At 10 colours some conflicted vertices have a free colour; at 2
    none has, and the first round takes the stall escape: every vertex
    it moves takes its random colour."""
    ell, params = _ell(layout, n_colors)
    if bands == "many":
        d_pad = max(n.shape[1] for _, n in tm._row_blocks(ell, bands=False))
        monkeypatch.setattr(tm, "_FUSED_NC_BYTES_CAP", 128 * d_pad * CHAINS * tm._SLOT_BYTES)
        assert len(list(tm._row_blocks(ell, chains=CHAINS))) > 2
    start = _start(ell, n_colors, 4)
    tc = {k: tm.TailcutState(start.clone(), np.zeros(CHAINS, np.int64),
                             np.zeros(CHAINS, np.int64), np.zeros(CHAINS, bool))
          for k in ("factored", "unfactored")}
    src = {k: _sources(9) for k in tc}
    for r in range(4):
        tc["factored"] = tm._tailcut_body(ell, tc["factored"], RUNNING, src["factored"],
                                          params=params)
        tc["unfactored"] = unfactored_round(ell, tc["unfactored"], RUNNING, src["unfactored"],
                                            params=params)
        a, b = tc["factored"], tc["unfactored"]
        assert torch.equal(a.colors_r, b.colors_r), r
        for x, y in zip((a.conflicts, a.rounds, a.done), (b.conflicts, b.rounds, b.done)):
            assert np.array_equal(x, y), r
        if r == 0:
            moved = a.colors_r[0] != start[0]
            escaped = bool((a.colors_r[0][moved] == src["factored"].last[0][moved]).all())
            assert bool(moved.any()) and escaped == (n_colors == 2)
    assert (a.conflicts[[0, 2]] > 0).all() or a.done[[0, 2]].any()
    assert torch.equal(a.colors_r[1], start[1])
    assert not torch.equal(a.colors_r[0], start[0])


@pytest.mark.parametrize("layout", ["flat", "bucketed"])
def test_tailcut_call_pieces(layout):
    """The tailcut call over row blocks at their ``row0`` (the flat ELL
    cut in two), phantom and padding rows among them: the first fit equals
    K3's greedy call, and the flag and count their one-gather formulas; a
    row of the first block, left out, keeps its fill; one colour vector
    equals chain 0 of three."""
    ell, params = _ell(layout, 10)
    n = params.n_colors
    colors = _start(ell, n, 5)
    out = torch.full(colors.shape, -7, dtype=torch.int32)
    flag = torch.zeros(colors.shape, dtype=torch.bool)
    count = torch.zeros((CHAINS,), dtype=torch.int64)
    pieces = list(tm._row_blocks(ell, bands=False))
    if layout == "flat":  # two bands, the second from row0 = 256
        pieces = [(0, pieces[0][1][:256]), (256, pieces[0][1][256:])]
    assert len(pieces) > 1 and pieces[1][0] > 0
    ids = torch.arange(ell.n_pad, dtype=torch.int32)
    want_count = torch.zeros((CHAINS,), dtype=torch.int64)
    for s, neigh in pieces[1:]:
        got = k3.first_fit(neigh, colors, None, n, row0=s, out=out, flag=flag, count=count)
        assert got is out
        e = s + neigh.shape[0]
        same = neighbor_colors_chains(neigh, colors) == colors[:, s:e, None]
        want_count += (same & (neigh > ids[s:e, None])[None]).sum((1, 2))
        assert torch.equal(flag[:, s:e], same.any(2))
        ones = torch.ones(n, dtype=torch.int32)
        assert torch.equal(out[:, s:e], k3.first_fit(neigh, colors, ones, n))
    assert torch.equal(count, want_count)
    assert bool((out[:, :pieces[1][0]] == -7).all())
    one = torch.zeros_like(out[0])
    k3.first_fit(pieces[-1][1], colors[0], None, n, row0=pieces[-1][0], out=one,
                 flag=torch.zeros_like(flag[0]), count=torch.zeros((), dtype=torch.int64))
    s = pieces[-1][0]
    assert torch.equal(one[s:], out[0, s:])


@pytest.mark.parametrize("share", [0.0, 0.05, 1.0])
def test_lower_movable_pass(share):
    """The second pass over row blocks at their ``row0``: a movable row
    with a movable neighbour of a lower id, 0 on the rows not movable."""
    ell, _ = _ell("bucketed", 10)
    gen = torch.Generator().manual_seed(3)
    movable = (torch.rand((CHAINS, ell.n_pad), generator=gen) < share) & ell.node_mask
    out = torch.ones_like(movable)
    for s, neigh in tm._row_blocks(ell, bands=False):
        assert k3.lower_movable(neigh, movable, row0=s, out=out) is out
    adj = torch.zeros((ell.n_pad, ell.n_pad + 1), dtype=torch.bool)
    for s, neigh in tm._row_blocks(ell, bands=False):
        rows = torch.arange(s, s + neigh.shape[0])[:, None].expand_as(neigh)
        adj[rows.reshape(-1), neigh.reshape(-1).long()] = True
    below = torch.ones((ell.n_pad, ell.n_pad), dtype=torch.bool).tril(-1)
    adj = adj[:, :ell.n_pad] & below
    want = ((adj[None] & movable[:, None, :]).any(2)) & movable
    assert torch.equal(out, want)
    assert bool(out.any()) == (share > 0)


def test_tailcut_call_refusals():
    ids = torch.zeros((4, 8), dtype=torch.int32)
    colors = torch.zeros((2, 10), dtype=torch.int32)
    outs = dict(out=torch.zeros((2, 10), dtype=torch.int32),
                flag=torch.zeros((2, 10), dtype=torch.bool),
                count=torch.zeros((2,), dtype=torch.int64))
    with pytest.raises(ValueError, match="allow and cur must be None"):
        k3.first_fit(ids, colors, None, 5, torch.zeros((2, 4), dtype=torch.int32), **outs)
    with pytest.raises(ValueError, match="allow and cur must be None"):
        k3.first_fit(ids, colors, torch.ones(5, dtype=torch.int32), 5, **outs)
    with pytest.raises(ValueError, match="outside"):
        k3.first_fit(ids, colors, None, 5, row0=7, **outs)
    with pytest.raises(TypeError, match="tailcut call wants"):
        k3.first_fit(ids, colors, None, 5, **{**outs, "count": torch.zeros(2)})
    with pytest.raises(ValueError, match="together"):
        k3.first_fit(ids, colors, None, 5, flag=outs["flag"])
    for call in (k3.first_fit, k3.first_fit_cuda):
        with pytest.raises(ValueError, match="only in the tailcut call"):
            call(ids, colors, None, 5)
    with pytest.raises(ValueError, match="CUDA"):
        k3.first_fit_cuda(ids, colors, None, 5, **outs)
    movable = torch.zeros((2, 10), dtype=torch.bool)
    with pytest.raises(ValueError, match="outside"):
        k3.lower_movable(ids, movable, row0=7, out=movable.clone())
    with pytest.raises(TypeError, match="movable"):
        k3.lower_movable(ids, movable.int(), out=movable.clone())
    with pytest.raises(ValueError, match="CUDA"):
        k3.lower_movable_cuda(ids, movable, out=movable.clone())
