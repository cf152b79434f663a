"""Kernels K1 (``csrc/packed_nc.cu``), K2 (``csrc/resample.cu``) and K3
(``csrc/first_fit.cu``) against their plain versions on the card.

The plain versions are what the CPU tests hold against the JAX package
(``test_torch_packed_nc.py``, ``test_torch_resample.py``,
``test_torch_firstfit.py``); here the kernels are held against them, on
the card, at the shapes the colourers launch them:

- K1 exactly: hash graphs of four densities and palettes, one of them
  wider than 48 KB of shared memory, and the resident chain's shape
  ER(100k, 0.01) at 1152 padded colours; rows of 2**16 set bits (the
  kernel's 32-bit path); a chain axis, equal to one launch a chain;
- K3 exactly: ids in and the colours looked up in the kernel, with
  ``allow`` and ``cur``, at 4500 colours on rows of whole 16-byte vectors
  and rows that are not, at a band of BASELINE config 3's shape, at a
  frontier's rows, with a chain axis (equal to one launch a chain), and
  at a shard's rows;
- K3's tailcut instance exactly (first fit, conflict flag, count) at
  config 3's width, at random ids on both of its read paths, over the
  flat and bucketed layouts (``row0``, phantom and padding rows), with a
  chain axis; the lower-movable kernel with no row, a few and every row
  movable; and whole tailcut rounds on the card against the plain round,
  the stall escape among them;
- K2 under ``cdf_boundary.py``'s rule with exact conflict counts: samples
  equal but where the uniform lies on a CDF step, new_taboo equal and
  qstar within 1e-5 (relative) where they agree; each case staged and
  forced to L2 (``_l2=True``) where the shape stages; at every proposal
  kind with taboo off and on, at 4500 colours, at the ER(100k, 0.01)
  sweep (staged) and a config-3 band (L2), at a frontier's rows with
  ``self_ids``, with a chain axis (equal to one launch a chain), and on
  shard 1 of a (1, 2) layout with its ``row0`` offset.  Config 3's whole
  sweep is marked ``slow``.

Imports no JAX: ``python -m pytest --noconftest -m card
tests/test_torch_card_kernels.py`` on the card.
"""

import numpy as np
import pytest
import torch

from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.graph.generate import erdos_renyi
from mcmc_colorer_tpu_torch.models import mcmc as tm
from mcmc_colorer_tpu_torch.models.mcmc_active import _rows_of
from mcmc_colorer_tpu_torch.ops import firstfit as k3
from mcmc_colorer_tpu_torch.ops import packed_nc as k1
from mcmc_colorer_tpu_torch.ops import resample as k2
from mcmc_colorer_tpu_torch.ops.dense_adj import n_col_pad_of
from mcmc_colorer_tpu_torch.ops.hashgen import er_packed_on_device
from mcmc_colorer_tpu_torch.ops.neighbor import color_histogram
from mcmc_colorer_tpu_torch.parallel.mesh import Mesh
from mcmc_colorer_tpu_torch.parallel.sharded import ShardedMCMCColorer

from torch_card import card, k2_agrees  # noqa: F401  (card: the fixture)

pytestmark = pytest.mark.card

CONFIG3_BAND = dict(rows=104_832, d_pad=1280, n_ids=2**20, n_real=1_000_000, max_degree=1173)
BENCH_SWEEP = dict(rows=100_000, d_pad=1152, n_ids=100_000, n_real=100_000, max_degree=1150)


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def _colors(n_real, n_ids, n_colors, gen, device, phantom):
    """[n_ids] int32 colours in [0, n_colors) for the real ids, ``phantom``
    past them."""
    c = torch.randint(0, n_colors, (n_ids,), generator=gen, device=device, dtype=torch.int32)
    c[n_real:] = phantom
    return c


def _er_band(device, gen, rows, d_pad, n_ids, n_real, max_degree):
    """[rows, d_pad] ids with ER degrees (mean 1000, sd 31.6, capped at
    ``max_degree``), each row's drawn from the first ``n_real`` ids and in
    order, the padding id ``n_ids`` in the rest of a row: the rows of a
    sweep or band of ER(100k, 0.01) or of config 3, ER(10^6, 0.001),
    without building the graph."""
    deg = (torch.randn((rows,), generator=gen, device=device) * 31.6 + 1000).round()
    deg = deg.clamp(0, max_degree).to(torch.int32)
    ids = torch.randint(0, n_real, (rows, d_pad), generator=gen, device=device,
                        dtype=torch.int32)
    slot = torch.arange(d_pad, device=device, dtype=torch.int32)[None, :]
    return torch.sort(torch.where(slot < deg[:, None], ids, n_ids), dim=1).values.contiguous()


# ------------------------------- K1 -------------------------------

# the three shapes of tests/test_matmul_backend.py:test_packed_nc_pallas_matches_dense,
# a palette wide enough (8064 padded colours) that K1 takes fewer rows a
# block and more than 48 KB of shared memory, and the resident chain's
@pytest.mark.parametrize("n, p, n_colors, n_pad, chains", [
    (n, p, c, n_pad, chains) for n, p, c, n_pad in (
        (1500, 0.05, 150, 1536), (4700, 0.01, 1100, 4736), (640, 0.3, 64, 640),
        (3000, 0.5, 8000, 3072)) for chains in (0, 3)
] + [(100_000, 0.01, 1152, 100_352, 0)])
def test_k1_is_the_plain_version(card, n, p, n_colors, n_pad, chains):
    adj = er_packed_on_device(n, p, 2, n_pad, row_chunk=128, device=card)
    gen = _gen(card, n + chains)
    colors = torch.stack([_colors(n, n_pad, n_colors, gen, card, -1)
                          for _ in range(max(chains, 1))])
    colors = colors if chains else colors[0]
    ncp = n_col_pad_of(n_colors)
    before = k1.launches
    got = k1.packed_nc_cuda(adj, colors, ncp)
    assert k1.launches == before + 1
    assert torch.equal(got, k1.packed_nc_reference(adj, colors, ncp))
    for c in range(chains):
        assert torch.equal(got[c], k1.packed_nc_cuda(adj, colors[c].contiguous(), ncp))


def test_k1_rows_of_2_16_set_bits(card):
    """Rows of 65,536 set bits and more take the kernel's 32-bit path."""
    gen = _gen(card, 5)
    wide = torch.randint(-2**31, 2**31 - 1, (64, 2048), generator=gen, device=card,
                         dtype=torch.int32)
    wide[::2] = -1  # every bit set
    cw = torch.randint(-1, 8, (2048 * 32,), generator=gen, device=card, dtype=torch.int32)
    assert torch.equal(k1.packed_nc_cuda(wide, cw, 128), k1.packed_nc_reference(wide, cw, 128))


# ------------------------------- K3 -------------------------------

def _k3_holds(neighbors, colors, allow, n_colors, cur=None):
    before = k3.launches
    got = k3.first_fit_cuda(neighbors, colors, allow, n_colors, cur)
    assert k3.launches == before + 1
    assert torch.equal(got, k3.first_fit_plain(neighbors, colors, allow, n_colors, cur))
    return got


def test_k3_with_allow_and_cur(card):
    """The shape of tests/test_pallas_firstfit.py:test_first_fit_kernel_matches_xla."""
    gen = _gen(card, 7)
    g = erdos_renyi(500, 0.05, seed=3)
    ell = g.to_ell(pad_nodes_to=128, device=card)
    ncol = g.max_degree + 1
    colors = torch.randint(-1, ncol, (ell.n_pad,), generator=gen, device=card, dtype=torch.int32)
    allow = torch.ones((ncol,), dtype=torch.int32, device=card)
    allow[::7] = 0
    _k3_holds(ell.neighbors, colors, allow, ncol, colors)


@pytest.mark.parametrize("d_pad", [40, 37])
def test_k3_wide_palette_random_ids(card, d_pad):
    """test_chunked_first_fit_wide_palette's 4500 colours: random ids (the
    padding id among them) into a random colour vector, rows of whole
    16-byte vectors and rows that are not."""
    gen = _gen(card, d_pad)
    n_ids = 1000
    colors = torch.randint(-1, 4500, (n_ids,), generator=gen, device=card, dtype=torch.int32)
    allow = torch.randint(0, 2, (4500,), generator=gen, device=card, dtype=torch.int32)
    allow[:64] = 0
    cur = torch.randint(-1, 4500, (256,), generator=gen, device=card, dtype=torch.int32)
    ids = torch.randint(0, n_ids + 1, (256, d_pad), generator=gen, device=card, dtype=torch.int32)
    _k3_holds(ids, colors, allow, 4500, cur)


@pytest.mark.parametrize("chains", [0, 3])
def test_k3_config3_band(card, chains):
    """A band of the ELL tailcut's first fit at config 3: its colour
    lookups come from a 4 MB vector in L2."""
    gen = _gen(card, 3 + chains)
    s = CONFIG3_BAND
    ids = _er_band(card, gen, **s)
    ncol = s["max_degree"]
    colors = torch.stack([_colors(s["n_real"], s["n_ids"], ncol, gen, card, ncol)
                          for _ in range(max(chains, 1))])
    allow = torch.ones((ncol,), dtype=torch.int32, device=card)
    got = _k3_holds(ids, colors if chains else colors[0], allow, ncol)
    for c in range(chains):
        assert torch.equal(got[c], k3.first_fit_cuda(ids, colors[c].contiguous(), allow, ncol))


@pytest.fixture
def er20k(card):
    """ER(20k, 0.01) from the native sampler, its flat ELL on the card."""
    g = erdos_renyi(20_000, 0.01, seed=5)
    return g, g.to_ell(pad_nodes_to=128, pad_degree_to=128, device=card)


def _frontier(ell, n_colors, cap, gen, chains=0):
    """A frontier of ``cap`` rows of ``ell`` as the frontier loops take
    it: three quarters of the cap real vertices drawn at random, in
    order, the padding id after them; their rows (``_rows_of``), the
    colours (phantoms at ``n_colors``) and each row's current colour
    (``n_colors`` on a padding row).  Returns (ids, valid, rows, colors,
    cur), the last two with a chain axis where ``chains``."""
    n, n_pad, dev = ell.n_nodes, ell.n_pad, ell.neighbors.device
    ids = torch.full((cap,), n_pad, dtype=torch.int32, device=dev)
    k = min(n, cap * 3 // 4)
    ids[:k] = torch.randperm(n, generator=gen, device=dev)[:k].sort().values
    valid = ids < n_pad
    rows = _rows_of(ell, ids, valid)
    colors = torch.stack([_colors(n, n_pad, n_colors, gen, dev, n_colors)
                          for _ in range(max(chains, 1))])
    cur = torch.where(valid, colors[:, ids.clamp(max=n_pad - 1).long()], n_colors)
    if not chains:
        colors, cur = colors[0], cur[0]
    return ids, valid, rows, colors.contiguous(), cur.contiguous()


@pytest.mark.parametrize("chains", [0, 3])
def test_k3_frontier_rows_with_allow_and_cur(card, er20k, chains):
    """VFF's frontier round: rows taken at a frontier's ids, some classes
    barred, each row's own colour in ``cur``."""
    g, ell = er20k
    gen = _gen(card, 20 + chains)
    ncol = g.max_degree + 1
    _, _, rows, colors, cur = _frontier(ell, ncol, 4096, gen, chains)
    allow = (torch.rand((ncol,), generator=gen, device=card) < 0.8).to(torch.int32)
    got = _k3_holds(rows, colors, allow, ncol, cur)
    for c in range(chains):
        assert torch.equal(got[c], k3.first_fit_cuda(rows, colors[c].contiguous(), allow, ncol,
                                                     cur[c].contiguous()))


# ------------------------- K3's tailcut call -------------------------

def _tailcut_outputs(colors, fill=-7):
    """Fresh outputs of K3's tailcut call for ``colors`` [C, n]: out, flag
    and count, filled so that a row the call leaves out shows."""
    return dict(out=torch.full(colors.shape, fill, dtype=torch.int32, device=colors.device),
                flag=torch.zeros(colors.shape, dtype=torch.bool, device=colors.device),
                count=torch.full(colors.shape[:-1], 3, dtype=torch.int64, device=colors.device))


def _k3_tailcut_holds(pieces, colors, n_colors):
    """K3's tailcut instance over ``pieces`` ((row0, ids) a launch, into
    one set of outputs) against the plain version's: ``cand``, ``flag``
    and the count of every chain bit for bit, and with more than one
    chain, each chain's launch alone.  Returns the outputs."""
    got, want = _tailcut_outputs(colors), _tailcut_outputs(colors)
    before = k3.launches
    for row0, ids in pieces:
        k3.first_fit_cuda(ids, colors, None, n_colors, row0=row0, **got)
        k3.first_fit_plain(ids, colors, None, n_colors, row0=row0, **want)
    assert k3.launches == before + len(pieces)
    for k in ("out", "flag", "count"):
        assert torch.equal(got[k], want[k]), k
    for c in range(colors.shape[0] if colors.shape[0] > 1 else 0):
        one = _tailcut_outputs(colors[c:c + 1])
        for row0, ids in pieces:
            k3.first_fit_cuda(ids, colors[c:c + 1].contiguous(), None, n_colors, row0=row0,
                              **one)
        for k in ("out", "flag", "count"):
            assert torch.equal(one[k][0], got[k][c]), k
    return got


@pytest.mark.parametrize("chains", [1, 4])
def test_k3_tailcut_config3_width(card, chains):
    """A band of config 3's flat ELL (d_pad 1,152) at rows from id 2**18
    on, as the tailcut launches it: about half the rows meet their own
    colour among ~1,000 neighbours; phantom ids past n_real hold nCol."""
    gen = _gen(card, 40 + chains)
    n_ids, n_real, ncol = 2**20, 1_000_000, 1151
    ids = _er_band(card, gen, rows=60_000, d_pad=1152, n_ids=n_ids, n_real=n_real,
                   max_degree=ncol)
    colors = torch.stack([_colors(n_real, n_ids, ncol, gen, card, ncol)
                          for _ in range(chains)])
    got = _k3_tailcut_holds([(2**18, ids)], colors, ncol)
    rows = slice(2**18, 2**18 + ids.shape[0])
    assert 0.2 < float(got["flag"][:, rows].float().mean()) < 0.8
    assert bool((got["out"][:, :2**18] == -7).all())  # no row outside the band written


@pytest.mark.parametrize("d_pad", [40, 37])
def test_k3_tailcut_random_ids(card, d_pad):
    """Random ids (the padding id among them) into colours in [-1, nCol]:
    rows of whole 16-byte vectors, whose last vector is part filler, and
    rows that are not (the kernel's scalar path); a row's own colour -1
    meets the padding slots' -1, as in the plain version."""
    gen = _gen(card, 50 + d_pad)
    n_ids, ncol = 3000, 9
    colors = torch.randint(-1, ncol + 1, (3, n_ids), generator=gen, device=card,
                           dtype=torch.int32)
    pieces = [(r0, torch.randint(0, n_ids + 1, (rows, d_pad), generator=gen, device=card,
                                 dtype=torch.int32))
              for r0, rows in ((0, 1000), (1000, 1500), (2500, 500))]
    got = _k3_tailcut_holds(pieces, colors, ncol)
    assert bool(got["flag"].any()) and bool((~got["flag"]).any())


@pytest.mark.parametrize("layout", ["flat", "bucketed"])
def test_k3_tailcut_layouts(card, layout):
    """BA(20k, 8) as the colourer lays it out: the flat ELL's one launch
    (padding rows past n), or one launch a degree class at its own width
    and ``row0`` = its start (phantom rows in every class); colours from a
    tailcut's start, rank space, phantoms at nCol."""
    from mcmc_colorer_tpu_torch.graph.generate import barabasi_albert

    g = barabasi_albert(20_000, 8, seed=4)
    params = MCMCParams(n_colors=12, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    ell = tm.MCMCColorer(g, params, backend="pallas", layout=layout, device=card).ell
    gen = _gen(card, 60)
    colors = torch.randint(0, 12, (2, ell.n_pad), generator=gen, device=card,
                           dtype=torch.int32)
    colors = torch.where(ell.node_mask, colors, 12).contiguous()
    pieces = list(tm._row_blocks(ell, bands=False))
    assert (len(pieces) > 1 and pieces[1][0] > 0) if layout == "bucketed" else len(pieces) == 1
    got = _k3_tailcut_holds(pieces, colors, 12)
    assert not bool(got["flag"][:, ~ell.node_mask].any())


@pytest.mark.parametrize("share", [0.0, 0.01, 1.0])
@pytest.mark.parametrize("layout", ["flat", "bucketed"])
def test_lower_movable(card, layout, share):
    """The tailcut's second pass against its plain version with no row
    movable, a few and all, over both layouts (a launch a degree class at
    its ``row0``) and three chains, each equal to its launch alone."""
    from mcmc_colorer_tpu_torch.graph.generate import barabasi_albert

    g = barabasi_albert(20_000, 8, seed=4)
    params = MCMCParams(n_colors=12, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    ell = tm.MCMCColorer(g, params, backend="pallas", layout=layout, device=card).ell
    gen = _gen(card, 70)
    movable = (torch.rand((3, ell.n_pad), generator=gen, device=card) < share) & ell.node_mask
    got = torch.ones_like(movable)
    want = torch.zeros_like(movable)
    before = k3.lower_launches
    pieces = list(tm._row_blocks(ell, bands=False))
    for row0, ids in pieces:
        k3.lower_movable_cuda(ids, movable, row0=row0, out=got)
        k3.lower_movable_plain(ids, movable, row0=row0, out=want)
    assert k3.lower_launches == before + len(pieces)
    assert torch.equal(got, want)
    assert bool(want.any()) == (share > 0)
    for c in range(3):
        one = torch.ones_like(movable[:1])
        for row0, ids in pieces:
            k3.lower_movable_cuda(ids, movable[c:c + 1].contiguous(), row0=row0, out=one)
        assert torch.equal(one[0], got[c])


class _Draws:
    """A chain's source that hands out the round's given random colours."""

    def __init__(self, rnd):
        self.rnd = rnd

    def randint(self, n, high, low=0):
        assert self.rnd.shape == (n,)
        return self.rnd


@pytest.mark.parametrize("n_colors", [24, 3], ids=["movable", "stalled"])
@pytest.mark.parametrize("layout", ["flat", "bucketed"])
def test_tailcut_round_is_the_plain_round(card, layout, n_colors):
    """Whole ``_tailcut_body`` rounds of three chains, one of them not
    running, on the card (K3's tailcut call and the lower-movable kernel)
    against the same rounds on a CPU copy (the plain round, in bands), on
    ER(3000, 0.03): colours, conflicts, rounds and exit flags equal after
    each.  At 24 colours some conflicted vertices have a free colour; at 3
    none has (degrees ~90): the first round takes the stall escape, every
    vertex it moves taking its random colour."""
    from mcmc_colorer_tpu_torch.utils.rng import ChainSources

    g = erdos_renyi(3000, 0.03, seed=8)
    params = MCMCParams(n_colors=n_colors, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    cpu = torch.device("cpu")
    on = {d: tm.MCMCColorer(g, params, backend="pallas", layout=layout, device=d).ell
          for d in (card, cpu)}
    gen = _gen(card, 80)
    colors = torch.randint(0, n_colors, (3, on[card].n_pad), generator=gen, device=card,
                           dtype=torch.int32)
    colors = torch.where(on[card].node_mask, colors, n_colors).contiguous()
    running = np.array([True, False, True])
    tc = {d: tm.TailcutState(colors.to(d), np.zeros(3, np.int64), np.zeros(3, np.int64),
                             np.zeros(3, bool)) for d in on}
    for r in range(3):
        rnd = torch.randint(0, n_colors, (3, colors.shape[1]), generator=gen, device=card,
                            dtype=torch.int32)
        for d in on:
            src = ChainSources([_Draws(rnd[k].to(d)) for k in range(3)], d)
            tc[d] = tm._tailcut_body(on[d], tc[d], running, src, params=params)
        a, b = tc[card], tc[cpu]
        assert torch.equal(a.colors_r.cpu(), b.colors_r)
        assert all(np.array_equal(x, y) for x, y in
                   zip((a.conflicts, a.rounds, a.done), (b.conflicts, b.rounds, b.done)))
        if r == 0:
            assert (a.conflicts[[0, 2]] > 0).all()
            moved = a.colors_r[0] != colors[0]
            escaped = bool((a.colors_r[0][moved] == rnd[0][moved]).all())
            assert bool(moved.any()) and (escaped or n_colors == 24)
    assert torch.equal(a.colors_r[1], colors[1])  # not running: kept
    assert not torch.equal(a.colors_r[0], colors[0])  # moved, or escaped


# ------------------------------- K2 -------------------------------

def _k2_inputs(neighbors, colors, params, gen, taboo_max, node_mask, n_real, chains=0):
    """K2's per-chain inputs over the rows of ``neighbors`` beside the
    colours ``colors`` ([n_ids], or [C, n_ids] with ``chains``): cur, the
    rows' own colours; taboo counters up to ``taboo_max``; uniforms; and
    p_eff from each chain's histogram.  Returns the positional arguments
    of ``resample_sweep_cuda`` up to ``p_eff``."""
    rows = neighbors.shape[0]
    dev = neighbors.device
    lead = (chains,) if chains else ()
    cur = colors[..., :rows].contiguous()
    taboo = torch.randint(0, taboo_max + 1, (*lead, rows), generator=gen, device=dev,
                          dtype=torch.int32)
    unif = torch.rand((*lead, rows), generator=gen, device=dev)
    p_eff = None
    if params.proposal != ProposalKind.STANDARD:
        each = []
        for c in (colors if chains else colors[None]):
            hist = color_histogram(c, params.n_colors, node_mask) if tm._needs_histogram(
                params) else None
            each.append(tm._variant_distribution(params, hist, n_real, dev))
        p_eff = torch.stack(each) if chains else each[0]
    return [neighbors, colors, cur, taboo, 0, unif, p_eff]


def _k2_holds(args, params, self_ids=None, staged=None):
    """K2 against its plain version in the regime the shape takes (which
    must be ``staged`` where given) and forced to L2, and, with a chain
    axis, each chain against its own single launch, exactly."""
    colors = args[1]
    chains = colors.shape[0] if colors.dim() == 2 else 0
    shape = k2.sweep_shape(colors.shape[-1], params.n_colors)
    assert staged is None or shape.staged == staged
    want = k2.resample_sweep_plain(*args, params.epsilon, params, self_ids)
    for l2 in ((False, True) if shape.staged else (False,)):
        before = k2.launches
        got = k2.resample_sweep_cuda(*args, params.epsilon, params, self_ids, _l2=l2)
        assert k2.launches == before + 1
        for c in range(max(chains, 1)):
            pick = (lambda x: x[c]) if chains else (lambda x: x)  # noqa: E731
            one = [a if i in (0, 4) or a is None else pick(a).contiguous()
                   for i, a in enumerate(args)]
            k2_agrees([pick(x) for x in got], [pick(x) for x in want], one, params)
            if chains:
                single = k2.resample_sweep_cuda(*one, params.epsilon, params, self_ids, _l2=l2)
                assert all(torch.equal(pick(a), b) for a, b in zip(got[:3], single[:3]))
                assert int(got[3][c]) == int(single[3])


KINDS = [ProposalKind.STANDARD, ProposalKind.BALANCE_DYNAMIC, ProposalKind.DECREASE_EXP,
         ProposalKind.BALANCE_LINE]


@pytest.mark.parametrize("taboo", [0, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_k2_every_kind(card, kind, taboo):
    """tests/test_pallas_resample.py:test_pallas_matches_xla_sweep's shape."""
    g = erdos_renyi(500, 0.05, seed=3)
    ell = g.to_ell(pad_nodes_to=128, device=card)
    p = MCMCParams(n_colors=g.max_degree, proposal=kind, taboo_iterations=taboo, epsilon=1e-4)
    gen = _gen(card, taboo)
    colors = _colors(ell.n_nodes, ell.n_pad, p.n_colors, gen, card, p.n_colors)
    _k2_holds(_k2_inputs(ell.neighbors[:ell.n_nodes], colors[:ell.n_nodes], p, gen, 1,
                         ell.node_mask[:ell.n_nodes], ell.n_nodes), p)


@pytest.mark.parametrize("kind", KINDS[:3])
def test_k2_wide_palette(card, kind):
    """test_chunked_kernel_wide_palette_matches_xla: 4500 colours."""
    g = erdos_renyi(512, 0.05, seed=3, use_native=False)
    ell = g.to_ell(pad_nodes_to=128, device=card)
    p = MCMCParams(n_colors=4500, proposal=kind, taboo_iterations=2, epsilon=1e-6)
    gen = _gen(card, 4500)
    colors = _colors(ell.n_nodes, ell.n_nodes, p.n_colors, gen, card, p.n_colors)
    _k2_holds(_k2_inputs(ell.neighbors[:ell.n_nodes], colors, p, gen, 1, None, ell.n_nodes), p)


@pytest.mark.parametrize("shape, staged", [
    pytest.param(BENCH_SWEEP, True, id="er100k-sweep"),
    pytest.param(CONFIG3_BAND, False, id="config3-band"),
    pytest.param({**CONFIG3_BAND, "rows": 1_000_000}, False, id="config3-sweep",
                 marks=pytest.mark.slow),
])
def test_k2_at_the_sweeps_shapes(card, shape, staged):
    """Balance-dynamic, the main paths' sweep: at ER(100k, 0.01) the colour
    vector staged in shared memory, at config 3 read from L2."""
    gen = _gen(card, shape["rows"])
    ids = _er_band(card, gen, **shape)
    ncol = shape["max_degree"]
    p = MCMCParams(n_colors=ncol, proposal=ProposalKind.BALANCE_DYNAMIC)
    colors = _colors(shape["n_real"], shape["n_real"], ncol, gen, card, ncol)
    _k2_holds(_k2_inputs(ids, colors, p, gen, 0, None, shape["n_real"]), p, staged=staged)


@pytest.mark.parametrize("chains", [0, 3])
def test_k2_frontier_rows_with_self_ids(card, er20k, chains):
    """The frontier iteration's launch: rows taken at the frontier's ids,
    which K2 gets as ``self_ids``, padding rows among them."""
    g, ell = er20k
    gen = _gen(card, 30 + chains)
    p = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC,
                   taboo_iterations=2)
    ids, _, rows, colors, cur = _frontier(ell, p.n_colors, 4096, gen, chains)
    args = _k2_inputs(rows, colors[..., :ell.n_nodes].contiguous(), p, gen, 2,
                      ell.node_mask[:ell.n_nodes], ell.n_nodes, chains)
    args[2] = cur
    _k2_holds(args, p, self_ids=ids, staged=True)


def test_k2_and_k3_on_a_shards_rows(card, er20k):
    """Shard 1 of a (1, 2) layout as ``ShardedMCMCColorer`` lays it out:
    its rows are the flat ELL's, its own ids from ``row0`` = its offset,
    the colour vector whole; K2 over 8 chains at the largest ε the
    sharded sweep hands it (``_eps_eff`` caps ε·scale at 0.4 / (nCol − 1)),
    and K3 as the rank-space tailcut launches it."""
    g, _ = er20k
    p = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC,
                   taboo_iterations=2, epsilon=0.4 / (g.max_degree - 1))
    c = ShardedMCMCColorer(g, p, Mesh(1, 2, 0, 1, card), n_chains=8, backend="pallas")
    off, nr = c.offset, c.n_real
    flat = g.to_ell(pad_nodes_to=c.n_pad, pad_degree_to=c.d_pad, device=card).neighbors
    assert off > 0 and torch.equal(c.neighbors, flat[off:off + c.n_loc])
    gen = _gen(card, 30)
    colors = torch.stack([_colors(g.n, c.n_pad, p.n_colors, gen, card, p.n_colors)
                          for _ in range(8)])
    real = torch.arange(c.n_pad, device=card) < g.n
    args = [c.neighbors[:nr], colors[:, :g.n].contiguous(),
            colors[:, off:off + nr].contiguous(),
            torch.randint(0, 3, (8, nr), generator=gen, device=card, dtype=torch.int32),
            off, torch.rand((8, nr), generator=gen, device=card), tm._p_eff(colors, p, g.n, real)]
    _k2_holds(args, p)
    allow = torch.ones((p.n_colors,), dtype=torch.int32, device=card)
    _k3_holds(c.neighbors[:nr], colors[0].contiguous(), allow, p.n_colors)
