"""K3's plain versions against the JAX package's Pallas kernel
``pallas_first_fit`` (interpret mode on the CPU): the ids form
(``ops/firstfit.py:first_fit`` on CPU tensors, which gathers the
neighbours' colours and then fits) against ``pallas_first_fit`` on
``ext[neighbors]``, and the first fit over a gathered band
(``first_fit_reference``) against it on the same band.  Also the
neighbour gathers, and the colorers' refusal to run without a card
unless asked for the CPU.

First fit is integer work: every comparison is exact.  The CUDA kernel
itself runs only on the card, where ``chip_smoke.py`` holds it against
the same plain version, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.ops.neighbor import neighbor_colors as j_neighbor_colors
from mcmc_colorer_tpu.ops.neighbor import occupancy_matrix as j_occupancy
from mcmc_colorer_tpu.graph.container import Graph as JGraph
from mcmc_colorer_tpu.ops.pallas_firstfit import pallas_first_fit, pallas_palette_ok

from mcmc_colorer_tpu_torch.config import MCMCParams
from mcmc_colorer_tpu_torch.interop import graph_from_jax
from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer
from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer
from mcmc_colorer_tpu_torch.ops import firstfit as k3
from mcmc_colorer_tpu_torch.ops.neighbor import (
    extend_colors,
    neighbor_colors,
    occupancy_matrix,
)

torch.set_num_threads(2)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def medium(medium_er):
    """medium_er's ELL in both packages and random partial colours."""
    g = graph_from_jax(medium_er)
    je = medium_er.to_ell(pad_nodes_to=128)
    te = g.to_ell(pad_nodes_to=128, device="cpu")
    max_colors = medium_er.max_degree + 1
    rng = np.random.default_rng(1)
    colors = rng.integers(-1, max_colors, te.n_pad).astype(np.int32)
    nc_j = np.asarray(j_neighbor_colors(je.neighbors, jnp.asarray(colors)))
    nc_t = neighbor_colors(te.neighbors, t(colors))
    return max_colors, colors, nc_j, nc_t, te.neighbors


def _jax_first_fit(nc, allow, n_colors, cur=None):
    """JAX's Pallas first fit (interpret mode) on a gathered band."""
    return np.asarray(pallas_first_fit(
        jnp.asarray(nc), jnp.asarray(allow), n_colors=n_colors, block=128,
        interpret=True, cur=None if cur is None else jnp.asarray(cur),
    ))


def _ext_gather(neighbors, colors):
    """ext[neighbors] in numpy: ids outside [0, len(colors)) land on -1."""
    ext = np.append(colors.astype(np.int32), np.int32(-1))
    return ext[np.where((neighbors >= 0) & (neighbors < colors.size), neighbors, colors.size)]


def test_gathers_match_jax(medium):
    max_colors, colors, nc_j, nc_t, _ = medium
    assert np.array_equal(nc_t.numpy(), nc_j)
    occ_j = np.asarray(j_occupancy(jnp.asarray(nc_j), max_colors))
    assert np.array_equal(occupancy_matrix(nc_t, max_colors).numpy(), occ_j)
    # colours outside [0, n_colors) count nowhere
    assert np.array_equal(
        occupancy_matrix(nc_t, 5).numpy(), np.asarray(j_occupancy(jnp.asarray(nc_j), 5))
    )
    ext = extend_colors(t(colors), fill=-2)
    assert ext.shape == (colors.size + 1,) and int(ext[-1]) == -2


@pytest.mark.parametrize("with_cur", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_first_fit_matches_jax(medium, with_cur, masked):
    """Mirrors tests/test_pallas_firstfit.py:test_first_fit_kernel_matches_xla:
    the first fit over a gathered band."""
    max_colors, colors, nc_j, nc_t, _ = medium
    allow = np.ones(max_colors, bool)
    if masked:
        allow[::7] = False
    cur = colors if with_cur else None
    want = _jax_first_fit(nc_j, allow, max_colors, cur)
    got = k3.first_fit_reference(nc_t, t(allow), max_colors, None if cur is None else t(cur))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("with_cur", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_first_fit_ids_matches_jax(medium, with_cur, masked):
    """The ids form, K3's interface: neighbour ids and the colour vector,
    against JAX's Pallas first fit on ext[neighbors]."""
    max_colors, colors, nc_j, _, neighbors = medium
    allow = np.ones(max_colors, bool)
    if masked:
        allow[::7] = False
    cur = colors if with_cur else None
    want = _jax_first_fit(nc_j, allow, max_colors, cur)
    before = k3.launches
    got = k3.first_fit(neighbors, t(colors), t(allow), max_colors,
                       None if cur is None else t(cur))
    assert k3.launches == before  # CPU tensors never reach the kernel
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, k3.first_fit_plain(neighbors, t(colors), t(allow), max_colors,
                                               None if cur is None else t(cur)))


def test_first_fit_wide_palette_matches_jax():
    """Mirrors test_chunked_first_fit_wide_palette: 4500 colours, which the
    TPU kernel walks in chunks and K3 serves in one pass."""
    rng = np.random.default_rng(11)
    n_pad, d_pad, n_colors = 256, 40, 4500
    nc = rng.integers(-1, n_colors, size=(n_pad, d_pad), dtype=np.int32)
    allow = rng.integers(0, 2, size=(n_colors,), dtype=np.int32)
    allow[:64] = 0  # force some first fits deep into the palette
    cur = rng.integers(-1, n_colors, size=(n_pad,), dtype=np.int32)
    want = _jax_first_fit(nc, allow, n_colors, cur)
    got = k3.first_fit_reference(t(nc), t(allow), n_colors, t(cur))
    assert np.array_equal(got.numpy(), want)
    assert (got.numpy() >= 64).sum() > 0


@pytest.mark.parametrize("d_pad", [40, 37])
def test_first_fit_ids_wide_palette_matches_jax(d_pad):
    """4500 colours in the ids form: random ids into a random colour
    vector, the sentinel id among them; a d_pad that is no multiple of 4
    takes the kernel's scalar loads on the card."""
    rng = np.random.default_rng(12)
    rows, n_ids, n_colors = 256, 1000, 4500
    colors = rng.integers(-1, n_colors, size=(n_ids,), dtype=np.int32)
    ids = rng.integers(0, n_ids + 1, size=(rows, d_pad), dtype=np.int32)
    allow = rng.integers(0, 2, size=(n_colors,), dtype=np.int32)
    allow[:64] = 0
    cur = rng.integers(-1, n_colors, size=(rows,), dtype=np.int32)
    want = _jax_first_fit(_ext_gather(ids, colors), allow, n_colors, cur)
    got = k3.first_fit(t(ids), t(colors), t(allow), n_colors, t(cur))
    assert np.array_equal(got.numpy(), want)
    assert (got.numpy() >= 64).sum() > 0


def test_first_fit_ids_padding_and_isolated_vertex():
    """A band with sentinel padding (d_pad above the max degree, phantom
    rows) and an isolated vertex, whose first fit is colour 0 (or the
    first allowed colour other than its own)."""
    src = np.array([1, 1, 2, 3, 5, 5, 5, 6], np.int64)
    dst = np.array([2, 3, 3, 4, 6, 7, 8, 8], np.int64)
    jg = JGraph.from_edges(10, src, dst)  # vertices 0 and 9 are isolated
    je = jg.to_ell(pad_nodes_to=128, pad_degree_to=8)
    te = graph_from_jax(jg).to_ell(pad_nodes_to=128, pad_degree_to=8, device="cpu")
    neighbors = te.neighbors.numpy()
    assert np.array_equal(neighbors, np.asarray(je.neighbors))
    assert (neighbors == te.n_pad).any() and (neighbors[0] == te.n_pad).all()
    rng = np.random.default_rng(3)
    n_colors = 5
    colors = rng.integers(0, n_colors, size=(te.n_pad,), dtype=np.int32)
    colors[10:] = n_colors  # phantoms hold a colour that counts nowhere
    for allow, cur in ((np.ones(n_colors, np.int32), None),
                       (np.array([0, 1, 1, 1, 1], np.int32), colors)):
        nc = np.asarray(j_neighbor_colors(je.neighbors, jnp.asarray(colors)))
        want = _jax_first_fit(nc, allow, n_colors, cur)
        got = k3.first_fit(te.neighbors, t(colors), t(allow), n_colors,
                           None if cur is None else t(cur))
        assert np.array_equal(got.numpy(), want)
    assert int(got[0]) == (1 if colors[0] != 1 else 2)


def test_first_fit_none_eligible():
    nc = torch.tensor([[0, 1, 2], [-1, -1, -1]], dtype=torch.int32)
    got = k3.first_fit_reference(nc, torch.ones(3, dtype=torch.int32), 3,
                                 torch.tensor([1, 0], dtype=torch.int32))
    assert got.tolist() == [-1, 1]
    ids = torch.tensor([[0, 1, 2], [3, 3, 3]], dtype=torch.int32)
    got = k3.first_fit(ids, torch.tensor([0, 1, 2], dtype=torch.int32),
                       torch.ones(3, dtype=torch.int32), 3,
                       torch.tensor([1, 0], dtype=torch.int32))
    assert got.tolist() == [-1, 1]


def test_pack_bits():
    rng = np.random.default_rng(4)
    for n in (1, 31, 32, 33, 100, 4500):
        mask = rng.integers(0, 2, n)
        words = k3.pack_bits(t(mask)).numpy().view(np.uint32)
        assert words.shape == ((n + 31) // 32,)
        bits = (words[:, None] >> np.arange(32, dtype=np.uint32)) & 1
        assert np.array_equal(bits.reshape(-1)[:n], mask)
        assert not bits.reshape(-1)[n:].any()


def test_palette_bound_and_checks():
    """K3's palette bound comes from shared memory: one row's bitmask in
    232,448 bytes.  It admits every palette the TPU kernel admitted."""
    assert k3.PALETTE_MAX == 232_448 * 8 and k3.PALETTE_MAX % 128 == 0
    for n in (1, 3072, 4500, 20000, 32768):
        assert pallas_palette_ok(n) and k3.palette_ok(n)
    assert k3.palette_ok(k3.PALETTE_MAX) and not k3.palette_ok(k3.PALETTE_MAX + 1)
    nc = torch.zeros((4, 8), dtype=torch.int32)
    colors = torch.zeros(16, dtype=torch.int32)
    ones = torch.ones(5, dtype=torch.int32)
    with pytest.raises(TypeError):
        k3.first_fit(nc.to(torch.int64), colors, ones, 5)
    with pytest.raises(TypeError, match="colors"):
        k3.first_fit(nc, colors.to(torch.int64), ones, 5)
    with pytest.raises(ValueError, match="allow"):
        k3.first_fit(nc, colors, ones[:4], 5)
    with pytest.raises(TypeError, match="cur"):
        k3.first_fit(nc, colors, ones, 5, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        k3.first_fit_cuda(nc, colors, ones, 5)


@pytest.mark.parametrize("n_colors, shape", [
    (1173, (8, 4)),                  # config 3: 8 rows of 4 copies
    (4500, (8, 4)),
    (100_000, (8, 2)),               # fewer copies before fewer rows
    (k3.PALETTE_MAX, (1, 1)),        # one row, one mask: the widest palette
])
def test_kernel_shape_fits_shared_memory(n_colors, shape):
    rows, copies = k3._kernel_shape(n_colors)
    assert (rows, copies) == shape
    assert rows * ((n_colors + 31) // 32) * copies * 4 <= k3.SMEM_BLOCK_BYTES


@pytest.mark.parametrize("make", ["mcmc", "greedy_ff", "resident"])
def test_colorers_default_to_the_card(medium_er, monkeypatch, make):
    """Built with their default device and no CUDA, the colorers raise
    and name the missing device; asked for the CPU, they run there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = graph_from_jax(medium_er)
    p = MCMCParams(n_colors=g.max_degree)
    build = {
        "mcmc": lambda **kw: MCMCColorer(g, p, **kw),
        "greedy_ff": lambda **kw: GreedyFFColorer(g, **kw),
        "resident": lambda **kw: ResidentMCMCColorer(300, 0.05, 1, **kw),
    }[make]
    for kw in ({}, {"device": "cuda"}, {"device": None}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(**kw)
    assert build(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("build", ["to_ell", "to_ell_bucketed", "er_packed_on_device",
                                   "er_packed_and_degrees", "er_packed_on_device_cached"])
def test_layout_builders_default_to_the_card(medium_er, monkeypatch, build):
    """The public layout builders put their tensors on the card by
    default, as JAX's put theirs on its default device: without CUDA they
    raise and name the missing device (for the default, "cuda" and None);
    asked for the CPU, they build there."""
    from mcmc_colorer_tpu_torch.ops import hashgen

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = graph_from_jax(medium_er)
    g_sorted = g.degree_relabel()[0]
    make = {
        "to_ell": lambda **kw: g.to_ell(pad_nodes_to=128, **kw).neighbors,
        "to_ell_bucketed": lambda **kw: g_sorted.to_ell_bucketed(**kw).degrees,
        "er_packed_on_device": lambda **kw: hashgen.er_packed_on_device(
            300, 0.05, 1, 512, row_chunk=256, **kw),
        "er_packed_and_degrees": lambda **kw: hashgen.er_packed_and_degrees(
            300, 0.05, 1, 512, row_chunk=256, **kw)[1],
        "er_packed_on_device_cached": lambda **kw: hashgen.er_packed_on_device_cached(
            300, 0.05, 1, 512, row_chunk=256, **kw)[0],
    }[build]
    for kw in ({}, {"device": "cuda"}, {"device": None}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(**kw)
    assert make(device="cpu").device == torch.device("cpu")
