"""The port's graph layer against the JAX package's: container, samplers,
native bindings, ELL layout and file I/O.

Everything here is integer (or string) work, so every comparison is
exact: CSR arrays, node names, ELL rectangles and files must be equal.
"""

import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.graph import generate as jgen
from mcmc_colorer_tpu.graph import io as jio
from mcmc_colorer_tpu.graph import native as jnative
from mcmc_colorer_tpu.graph.container import Graph as JGraph

from mcmc_colorer_tpu_torch.graph import generate as tgen
from mcmc_colorer_tpu_torch.graph import io as tio
from mcmc_colorer_tpu_torch.graph import native as tnative
from mcmc_colorer_tpu_torch.graph.container import Graph, degree_pad_for
from mcmc_colorer_tpu_torch.interop import ell_to_numpy, graph_from_jax
from mcmc_colorer_tpu_torch.ops.ell_build import ell_neighbors_from_csr_device

torch.set_num_threads(2)


def assert_same_graph(t, j, names=True):
    assert t.n == j.n
    assert np.array_equal(t.row_ptr, j.row_ptr)
    assert np.array_equal(t.cols, j.cols)
    assert t.row_ptr.dtype == np.int64 and t.cols.dtype == np.int32
    if names:
        assert t.node_names == j.node_names
    assert (t.n_edges, t.max_degree) == (j.n_edges, j.max_degree)
    assert np.array_equal(t.degrees, j.degrees)
    assert t.mean_degree == j.mean_degree and t.density == j.density


def random_edges(seed, n=200, m=900):
    """Edges with self-loops and duplicates, as raw files have."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src[:20], dst[:20] = src[20:40], dst[20:40]  # duplicates
    dst[40:45] = src[40:45]  # self-loops
    return n, src, dst


@pytest.mark.parametrize("seed", [0, 1])
def test_container_matches_jax(seed):
    n, src, dst = random_edges(seed)
    j = JGraph.from_edges(n, src, dst, name="x")
    t = Graph.from_edges(n, src, dst, name="x")
    assert_same_graph(t, j)
    t.validate()
    j.validate()
    assert_same_graph(t.dedup_edges(), j.dedup_edges())
    for desc in (False, True):
        (tg, tp), (jg, jp) = t.degree_relabel(desc), j.degree_relabel(desc)
        assert_same_graph(tg, jg)
        assert np.array_equal(tp, jp) and tg.name == jg.name
    for i in (0, 7, n - 1):
        assert np.array_equal(t.neighbors_of(i), j.neighbors_of(i))
    # a one-way edge is refused by both
    bad = Graph(n=3, row_ptr=np.array([0, 1, 1, 1]), cols=np.array([1], np.int32))
    with pytest.raises(ValueError, match="mirrored"):
        bad.validate()
    with pytest.raises(AssertionError):
        JGraph(n=3, row_ptr=bad.row_ptr, cols=bad.cols).validate()


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.erdos_renyi(700, 0.03, seed=5, use_native=False),
        lambda m: m.erdos_renyi(40, 1.0, seed=1, use_native=False),
        lambda m: m.erdos_renyi(50, 0.0, seed=1, use_native=False),
        lambda m: m.barabasi_albert(600, 4, seed=2, use_native=False),
        lambda m: m.erdos_renyi(3000, 0.01, seed=9, use_native=True),
        lambda m: m.barabasi_albert(4000, 6, seed=3, use_native=True),
    ],
    ids=["er-numpy", "er-complete", "er-empty", "ba-numpy", "er-native", "ba-native"],
)
def test_generators_match_jax(make):
    t, j = make(tgen), make(jgen)
    assert_same_graph(t, j)
    assert t.name == j.name
    assert t.simple_certified and j.simple_certified
    t.validate()


def test_native_bindings_match_jax(tmp_path):
    assert_same_graph(tnative.generate_er(2000, 0.02, seed=4),
                      jnative.generate_er(2000, 0.02, seed=4))
    assert_same_graph(tnative.generate_ba(1500, 3, seed=8),
                      jnative.generate_ba(1500, 3, seed=8))
    with pytest.raises(ValueError, match="m_per_node"):
        tnative.generate_ba(3, 5)
    for named in (True, False):
        a, b = tmp_path / f"t{named}.txt", tmp_path / f"j{named}.txt"
        m_t = tnative.generate_dataset(str(a), 300, 0.05, seed=3, named=named)
        m_j = jnative.generate_dataset(str(b), 300, 0.05, seed=3, named=named)
        assert m_t == m_j and a.read_bytes() == b.read_bytes()
    with pytest.raises(OSError):
        tnative.load_edge_list(str(tmp_path / "missing.txt"))


def test_random_node_names_match_jax():
    rng_t, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    assert tgen.random_node_names(50, rng_t) == jgen.random_node_names(50, rng_j)


@pytest.mark.parametrize("fixture", ["small_er", "medium_er"])
@pytest.mark.parametrize("pad_degree", [8, 128])
def test_to_ell_matches_jax(request, fixture, pad_degree):
    jg = request.getfixturevalue(fixture)
    t = graph_from_jax(jg)
    assert_same_graph(t, jg)
    je = jg.to_ell(pad_nodes_to=128, pad_degree_to=pad_degree)
    te = t.to_ell(pad_nodes_to=128, pad_degree_to=pad_degree, device="cpu")
    for a, b in zip(ell_to_numpy(te), ell_to_numpy(je)):
        assert np.array_equal(a, b)
    assert (te.n_pad, te.d_pad, te.n_nodes, te.n_edges, te.max_degree) == (
        je.n_pad, je.d_pad, je.n_nodes, je.n_edges, je.max_degree
    )
    assert np.array_equal(te.node_mask.numpy(), np.asarray(je.node_mask))
    assert degree_pad_for(t, "pallas") == 8  # max degree < 128 on both graphs
    # device build (here on the CPU) is bit-equal to the host build
    dev = ell_neighbors_from_csr_device(t.row_ptr, t.cols, te.n_pad, te.d_pad, band_edges=256)
    assert np.array_equal(dev.numpy(), ell_to_numpy(te)[0])


def host_rect(g, n_pad, d_pad):
    neigh = np.full((n_pad, d_pad), n_pad, dtype=np.int32)
    row = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees)
    col = np.arange(g.cols.shape[0]) - np.repeat(g.row_ptr[:-1], g.degrees)
    neigh[row, col] = g.cols
    return neigh


@pytest.mark.parametrize(
    "g, band",
    [
        (tgen.erdos_renyi(500, 0.05, seed=3), 256),       # many bands
        (tgen.erdos_renyi(300, 0.02, seed=1), 1 << 20),   # one band
        (tgen.barabasi_albert(800, 5, seed=2), 512),      # skewed degrees
        # vertex 0 isolated (a row boundary at exactly 0) and empty rows
        (Graph.from_edges(10, np.array([1, 1, 5, 7]), np.array([3, 5, 7, 9])), 4),
    ],
    ids=["er-multiband", "er-oneband", "ba-skewed", "isolated-zero"],
)
def test_device_ell_build_bit_equal(g, band):
    """Mirrors tests/test_ell_build.py."""
    n_pad = (g.n + 127) // 128 * 128
    d_pad = (g.max_degree + 7) // 8 * 8
    stats = {}
    dev = ell_neighbors_from_csr_device(g.row_ptr, g.cols, n_pad, d_pad, stats=stats,
                                        band_edges=band)
    assert np.array_equal(dev.numpy(), host_rect(g, n_pad, d_pad))
    assert stats["bands"] == -(-g.cols.shape[0] // band)
    assert stats["upload_bytes"] == (g.n + 1) * 8 + g.cols.shape[0] * 4


def test_to_ell_cache_evicts_before_build():
    g = tgen.erdos_renyi(300, 0.05, seed=2)
    a = g.to_ell(pad_nodes_to=128, device="cpu")
    assert g.to_ell(pad_nodes_to=128, device="cpu") is a  # cached
    b = g.to_ell(pad_nodes_to=512, device_build=True, device="cpu")
    assert list(g._ell_cache) == [(512, b.d_pad, "cpu")]  # the larger one replaced it
    c = g.to_ell(pad_nodes_to=128, device="cpu")  # smaller: built, not cached
    assert c is not a and list(g._ell_cache) == [(512, b.d_pad, "cpu")]
    assert np.array_equal(b.neighbors.numpy()[:300], np.where(
        c.neighbors.numpy()[:300] == 384, 512, c.neighbors.numpy()[:300]))


def test_edge_list_round_trip_matches_jax(tmp_path):
    jg = jgen.erdos_renyi(400, 0.03, seed=6, use_native=False)
    g = graph_from_jax(jg)
    g.node_names = tgen.random_node_names(g.n, np.random.default_rng(2))
    path = tmp_path / "g.txt"
    tio.write_edge_list(g, str(path), rng=np.random.default_rng(1))
    jpath = tmp_path / "g_jax.txt"
    jg.node_names = list(g.node_names)
    jio.write_edge_list(jg, str(jpath), rng=np.random.default_rng(1))
    assert path.read_bytes() == jpath.read_bytes()
    native = tio.load_edge_list(str(path))
    py = tio.load_edge_list_py(str(path))
    assert_same_graph(native, jio.load_edge_list(str(path)))
    assert_same_graph(py, jio.load_edge_list_py(str(path)))
    assert native.name == py.name == "g"
    assert native.n_edges == g.n_edges and native.max_degree == g.max_degree
    # the two importers order a row's neighbours differently, nothing else
    assert native.node_names == py.node_names
    assert np.array_equal(native.row_ptr, py.row_ptr)
    for i in range(native.n):
        assert np.array_equal(np.sort(native.neighbors_of(i)), np.sort(py.neighbors_of(i)))


def test_converters_match_jax(tmp_path):
    raw = tmp_path / "soc.mtx"
    raw.write_text("%% header\n6 6 7\n0 1\n1 2\n2 2\n3 4 0.5\n4,5\n5 5\n0 3\n")
    for mod, tag in ((tio, "t"), (jio, "j")):
        mod.convert_network_repository(str(raw), str(tmp_path / f"{tag}.txt"))
        n = mod.strip_self_arcs(str(tmp_path / f"{tag}.txt"), str(tmp_path / f"{tag}2.txt"))
        assert n == 2
        mod.convert_reddit_csv(str(raw), str(tmp_path / f"{tag}r.txt"), every_other_line=True)
        mod.write_colors(str(tmp_path / f"{tag}c.txt"), np.array([2, 0, 1]))
    for suffix in (".txt", "2.txt", "r.txt", "c.txt"):
        assert (tmp_path / f"t{suffix}").read_bytes() == (tmp_path / f"j{suffix}").read_bytes()
    assert_same_graph(tio.load_edge_list(str(tmp_path / "t2.txt")),
                      jio.load_edge_list(str(tmp_path / "j2.txt")))
