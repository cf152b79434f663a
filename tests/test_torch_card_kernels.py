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
