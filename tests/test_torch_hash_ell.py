"""Kernel K5's wrapper and the graph it builds (``ops/hash_ell.py``,
``graph/container.py:HashGraph``).

On the CPU the plain version builds the ELL; its rows are held, as sets,
against the JAX package's ``hash_edges_reference`` (the definition the
port must match), at sizes off the padding, p = 0, p = 1, a p that leaves
isolated vertices and a seed at and above 2**31: rows ascending, padding
and phantom rows at the sentinel n_pad, degrees and edge counts exact.
``MCMCColorer`` over a ``HashGraph`` gives the colours it gives over the
host ``Graph`` of the same edges, at numColRatio 1, 2 and 4 with the
tailcut on; the colourers share one rectangle; the refusals.

The cases marked ``card`` hold K5 on the card (``python -m pytest
--noconftest -m card tests/test_torch_hash_ell.py``: the JAX package is
imported inside the CPU tests only, and does not run on the card): bit
for bit against the plain version, row sets against the host's native
enumerator at ER(100,000, 0.01), the self-check of the fill, and the
launch count.
"""

import numpy as np
import pytest
import torch

from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind, default_n_colors
from mcmc_colorer_tpu_torch.graph.container import Graph, HashGraph
from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer, choose_block_size
from mcmc_colorer_tpu_torch.ops import hash_ell as k5
from mcmc_colorer_tpu_torch.ops.hashgen import hash_er_graph

CASES = [  # (n, p, seed, n_pad, pad_degree_to)
    (300, 0.05, 3, 384, 8),            # n off the padding
    (257, 0.0, 1, 264, 8),             # no edge at all
    (400, 0.004, 5, 400, 8),           # isolated vertices
    (250, 0.1, 2**31 + 17, 256, 128),  # a seed above 31 bits
    (96, 1.0, 2**32 - 5, 104, 8),      # p = 1: every pair but h = 2**32 - 1
    (1, 0.5, 7, 8, 8),                 # one vertex
]


def _jax_rows(n, p, seed):
    from mcmc_colorer_tpu.ops.hashgen import hash_edges_reference

    e = hash_edges_reference(n, p, seed)
    rows = [set() for _ in range(n)]
    for a, b in e.tolist():
        rows[a].add(b)
        rows[b].add(a)
    return rows, len(e)


@pytest.mark.parametrize("n, p, seed, n_pad, pad", CASES)
def test_plain_rows_are_the_jax_reference(n, p, seed, n_pad, pad):
    neigh, degrees, max_degree = k5.hash_ell_plain(n, p, seed, n_pad, pad)
    rows, n_edges = _jax_rows(n, p, seed)
    want_deg = np.array([len(r) for r in rows])
    assert max_degree == int(want_deg.max())
    assert neigh.dtype == torch.int32 and neigh.shape == (n_pad, k5.d_pad_for(max_degree, pad))
    assert neigh.shape[1] % pad == 0 and neigh.shape[1] >= max(max_degree, 1)
    deg = degrees.numpy()
    assert np.array_equal(deg[:n], want_deg) and not deg[n:].any()
    a = neigh.numpy()
    for v in range(n):
        d = deg[v]
        assert a[v, :d].tolist() == sorted(rows[v])  # ascending, exact
        assert (a[v, d:] == n_pad).all()
    assert (a[n:] == n_pad).all()  # phantom rows
    g = HashGraph(n, p, seed, device="cpu")
    assert (g.n_edges, g.max_degree) == (n_edges, max_degree)
    assert np.array_equal(g.degrees, want_deg)


def test_the_two_passes_match_the_one_call():
    n, p, seed = 500, 0.03, 11
    deg = k5.hash_ell_degrees(n, p, seed, 512, "cpu")
    neigh = k5.hash_ell_fill(n, p, seed, deg, k5.d_pad_for(int(deg.max()), 8))
    ref, ref_deg, _ = k5.hash_ell_plain(n, p, seed, 512, 8)
    assert torch.equal(deg, ref_deg) and torch.equal(neigh, ref)


@pytest.mark.parametrize("lo, hi", [(0, 37), (123, 301), (470, 500), (480, 512), (500, 512),
                                    (200, 200)],
                         ids=["first", "middle", "last_real", "into_phantoms", "phantoms",
                              "empty"])
def test_a_band_of_plain_rows_is_the_whole_builds(monkeypatch, lo, hi):
    """``hash_ell_plain_rows`` (the rows a full-size check samples) equals
    those rows of the whole plain build, at bands of a few rows each."""
    monkeypatch.setattr(k5, "PLAIN_BAND_ELEMENTS", 7 * 500)
    n, p, seed = 500, 0.03, 2**31 + 5
    ref, ref_deg, max_degree = k5.hash_ell_plain(n, p, seed, 512, 8)
    rows, deg = k5.hash_ell_plain_rows(n, p, seed, 512, ref.shape[1], lo, hi)
    assert torch.equal(rows, ref[lo:hi]) and torch.equal(deg, ref_deg[lo:hi])


def test_the_fill_never_cuts_a_row():
    """A fill that finds another degree than the count's, or rows wider
    than d_pad, raises: no row is dropped or cut short."""
    n, p, seed = 300, 0.05, 3
    deg = k5.hash_ell_degrees(n, p, seed, 304, "cpu")
    bad = deg.clone()
    bad[17] -= 1
    with pytest.raises(RuntimeError, match="counted degree"):
        k5.hash_ell_fill(n, p, seed, bad, 32)
    with pytest.raises(RuntimeError, match="d_pad"):
        k5.hash_ell_fill(n, p, seed, deg, int(deg.max()) - 1)


@pytest.mark.parametrize("args", [(10, 0.1, 1, 9, 8), (10, 1.5, 1, 16, 8), (-1, 0.1, 1, 8, 8),
                                  (10, 0.1, 1, 2**31, 8)],
                         ids=["n_pad_below_n", "p_above_1", "negative_n", "n_pad_over_int32"])
def test_sizes_are_checked(args):
    with pytest.raises(ValueError):
        k5.hash_ell_plain(*args)


def test_k5_refuses_cpu_tensors_and_does_not_launch_on_the_cpu():
    before = k5.launches
    deg = torch.zeros((64,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        k5.hash_ell_cuda(deg, 60, 0.1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        k5.hash_ell_cuda(deg, 60, 0.1, 1, 8)
    with pytest.raises(TypeError):
        k5.hash_ell_cuda(deg.long(), 60, 0.1, 1)
    k5.hash_ell(60, 0.1, 1, 64, 8, "cpu")
    assert k5.launches == before == 0


def test_hash_graph_is_graph_from_edges():
    """The same graph as the host's enumerator's CSR: stats, and the ELL
    rows as sets (the host CSR orders a row by how its edges arrive)."""
    n, p, seed = 700, 0.03, 2**32 + 9
    hg = HashGraph(n, p, seed, device="cpu")
    g = hg.host_graph()
    assert (hg.n, hg.n_edges, hg.max_degree) == (g.n, g.n_edges, g.max_degree)
    assert np.array_equal(hg.degrees, g.degrees) and hg.mean_degree == pytest.approx(g.mean_degree)
    a = hg.to_ell(pad_nodes_to=128, pad_degree_to=8)
    b = g.to_ell(pad_nodes_to=128, pad_degree_to=8, device="cpu")
    assert (a.n_pad, a.d_pad) == (b.n_pad, b.d_pad)
    assert (a.neighbors[n:] == a.n_pad).all()
    want = torch.sort(b.neighbors[:n].clamp(max=n), dim=1).values
    assert torch.equal(a.neighbors[:n].clamp(max=n), want)
    assert torch.equal(a.degrees[:n], b.degrees[:n]) and not a.degrees[n:].any()
    assert a.n_edges == b.n_edges


def _params(hg, ratio):
    return MCMCParams(n_colors=default_n_colors(hg.max_degree, ratio), tailcut=True,
                      proposal=ProposalKind.BALANCE_DYNAMIC)


@pytest.mark.parametrize("ratio", [1, 2, 4])
def test_mcmc_over_a_hash_graph_equals_the_host_graph(ratio):
    n, p, seed = 900, 0.03, 11
    hg = HashGraph(n, p, seed, device="cpu")
    g = hg.host_graph()
    params = _params(hg, ratio)
    a = MCMCColorer(hg, params, device="cpu").run(3, ratio)
    b = MCMCColorer(g, params, device="cpu").run(3, ratio)
    assert np.array_equal(a.colors, b.colors)
    assert a.extra["final_conflicts"] == b.extra["final_conflicts"] == 0
    assert a.extra["sweeps"] == b.extra["sweeps"] and a.n_colors == b.n_colors


def test_a_ratio_sweep_shares_one_rectangle(monkeypatch):
    calls = []
    fill = k5.hash_ell_fill
    monkeypatch.setattr(k5, "hash_ell_fill", lambda *a: calls.append(a) or fill(*a))
    hg = HashGraph(3000, 0.01, 4, device="cpu")
    ells = [MCMCColorer(hg, _params(hg, r), device="cpu").ell for r in (1, 2, 4)]
    assert ells[0] is ells[1] is ells[2] and len(calls) == 1 and ells[0].n_pad == 4096
    # at config 3 the blocks differ with the palette (32,768 and 65,536 rows); each
    # divides the largest block at that n, to which a HashGraph's rows are padded,
    # so the padded rows, and the rectangle, are one
    n = 1_000_000
    blocks = {choose_block_size(n, default_n_colors(1151, r)) for r in (1, 2, 4)}
    assert len(blocks) > 1 and all(choose_block_size(n, 1) % b == 0 for b in blocks)


@pytest.mark.parametrize("kw", [dict(layout="bucketed"), dict(backend="matmul"),
                                dict(backend="packed")], ids=["bucketed", "matmul", "packed"])
def test_mcmc_refuses_what_needs_a_host_csr(kw):
    hg = HashGraph(200, 0.05, 1, device="cpu")
    with pytest.raises(ValueError, match="no host CSR"):
        MCMCColorer(hg, _params(hg, 1), device="cpu", **kw)


def test_the_ell_is_built_on_the_graphs_device():
    hg = HashGraph(200, 0.05, 1, device="cpu")
    with pytest.raises(ValueError, match="builds its ELL there"):
        hg.to_ell(device="meta")


def test_the_build_is_spanned():
    hg = HashGraph(300, 0.05, 1, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        hg.to_ell(pad_nodes_to=128)
    names = {e.name for e in prof.events()}
    assert {"mc.hash_ell", "mc.hash_ell.count", "mc.hash_ell.fill"} <= names


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K5 is a CUDA kernel with no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("n, p, seed, n_pad, pad", [
    (3000, 0.02, 5, 3072, 8),
    (3000, 0.3, 2**31 + 1, 3000, 128),
    (20000, 0.01, 0, 20480, 128),
    (20000, 0.001, 2**33 + 3, 20001, 8),
])
def test_kernel_is_the_plain_version_bit_for_bit(card, n, p, seed, n_pad, pad):
    before = k5.launches
    neigh, deg, max_degree = k5.hash_ell(n, p, seed, n_pad, pad, card)
    assert k5.launches == before + 2
    ref, ref_deg, ref_max = k5.hash_ell_plain(n, p, seed, n_pad, pad, device=card)
    assert max_degree == ref_max and torch.equal(deg, ref_deg)
    assert neigh.shape == ref.shape and torch.equal(neigh, ref)


@pytest.mark.card
def test_kernel_rows_are_the_native_enumerators(card):
    n, p, seed = 100_000, 0.01, 0
    hg = HashGraph(n, p, seed, device=card)
    g = hash_er_graph(n, p, seed)
    assert (hg.n_edges, hg.max_degree) == (g.n_edges, g.max_degree)
    assert np.array_equal(hg.degrees, g.degrees)
    a = hg.to_ell(pad_nodes_to=2048, pad_degree_to=128)
    b = g.to_ell(pad_nodes_to=2048, pad_degree_to=128, device=card)
    assert (a.n_pad, a.d_pad) == (b.n_pad, b.d_pad)
    want = torch.sort(b.neighbors[:n].clamp(max=n), dim=1).values
    assert torch.equal(a.neighbors[:n].clamp(max=n), want)
    assert (a.neighbors[n:] == a.n_pad).all()


@pytest.mark.card
def test_kernel_fill_checks_itself(card):
    n, p, seed = 5000, 0.01, 3
    deg = k5.hash_ell_degrees(n, p, seed, 5120, card)
    bad = deg.clone()
    bad[4321] += 1
    with pytest.raises(RuntimeError, match="counted degree"):
        k5.hash_ell_fill(n, p, seed, bad, 128)
    with pytest.raises(RuntimeError, match="d_pad"):
        k5.hash_ell_fill(n, p, seed, deg, int(deg.max()) - 1)
    with pytest.raises(ValueError, match="d_pad"):
        k5.hash_ell_cuda(deg, n, p, seed, 0)
