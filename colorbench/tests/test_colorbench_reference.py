"""The plain reference against independent oracles, and the program's
graphs judged by it at small sizes on the CPU."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from colorbench.reference import er_edges, greedy, hashgraph, quality

REF_DIR = Path(__file__).resolve().parents[1] / "reference"


def _numpy_hash_edges(n, p, seed):
    """murmur3 fmix32-style mix over uint32 in numpy: the definition once more."""
    t = np.uint64(min(0xFFFFFFFF, int(p * 4294967296.0)))
    i, j = np.triu_indices(n, k=1)
    m = np.uint64(0xFFFFFFFF)
    h = ((i.astype(np.uint64) ^ np.uint64((seed & 0xFFFFFFFF) ^ 0x9E3779B9)) * np.uint64(0x85EBCA6B)) & m
    h ^= h >> np.uint64(13)
    h = ((h ^ j.astype(np.uint64)) * np.uint64(0xC2B2AE35)) & m
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x27D4EB2F)) & m
    h ^= h >> np.uint64(15)
    keep = h < t
    return i[keep], j[keep]


def test_reference_imports_nothing_of_the_program():
    for f in REF_DIR.glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in {"jax", "jaxlib", "flax", "mcmc_colorer_tpu",
                                                  "mcmc_colorer_tpu_torch"}, (f.name, name)


@pytest.mark.parametrize("n,p,seed", [(300, 0.05, 7), (517, 0.3, 2**32 + 9)])
def test_hash_edges_equal_the_numpy_definition(n, p, seed):
    src, dst = hashgraph.hash_edges(n, p, seed, "cpu", band=64)
    i, j = _numpy_hash_edges(n, p, seed)
    assert np.array_equal(src.numpy(), i) and np.array_equal(dst.numpy(), j)


def test_programs_packed_adjacency_has_no_wrong_bit():
    from mcmc_colorer_tpu_torch.ops.hashgen import er_packed_on_device

    n, p, seed = 700, 0.04, 11
    adj = er_packed_on_device(n, p, seed, 2048, device="cpu")
    src, dst = hashgraph.hash_edges(n, p, seed, "cpu")
    assert hashgraph.adjacency_wrong_bits(adj, src, dst) == 0
    bad = adj.clone()
    w, b = (int(x) for x in hashgraph.word_bit(dst[:1].long()))
    bad[int(src[0]), w] ^= (1 << b) if b < 31 else -(1 << 31)  # an edge bit lost
    assert hashgraph.adjacency_wrong_bits(bad, src, dst) == 1
    w0, b0 = (int(x) for x in hashgraph.word_bit(torch.tensor([0])))
    bad[0, w0] |= 1 << b0  # a self-loop: a set bit that is no edge
    assert hashgraph.adjacency_wrong_bits(bad, src, dst) == 2


def test_er_edges_is_seeded_gnp():
    n, p = 2000, 0.01
    s1, d1 = er_edges.er_edges(n, p, 2**33 + 5)
    s2, d2 = er_edges.er_edges(n, p, 2**33 + 5)
    assert np.array_equal(s1, s2) and np.array_equal(d1, d2)
    assert (s1 < d1).all() and (d1 < n).all() and (s1 >= 0).all()
    pairs = s1.astype(np.int64) * n + d1
    assert np.unique(pairs).size == pairs.size
    mean = n * (n - 1) / 2 * p
    assert abs(s1.size - mean) < 5 * np.sqrt(mean)
    s3, _ = er_edges.er_edges(n, p, 2**33 + 6)
    assert not np.array_equal(s1[:50], s3[:50])


def test_csr_rows_ascending_and_symmetric():
    src, dst = np.array([0, 0, 1]), np.array([2, 1, 2])
    rp, cols = er_edges.csr(3, src, dst)
    assert rp.tolist() == [0, 2, 4, 6] and cols.tolist() == [1, 2, 0, 2, 0, 1]


def _graph(n=400, p=0.05, seed=3):
    s, d = er_edges.er_edges(n, p, seed)
    return s, d, *er_edges.csr(n, s, d)


def test_reference_greedy_ff_is_a_valid_first_fit():
    s, d, rp, cols = _graph()
    c = greedy.greedy_ff(rp, cols)
    assert (c >= 0).all() and quality.conflict_edges(torch.from_numpy(c), torch.from_numpy(s),
                                                     torch.from_numpy(d)) == 0
    for v in range(rp.size - 1):  # first fit: every smaller colour is taken by a neighbour
        nb = set(c[cols[rp[v]:rp[v + 1]]].tolist())
        assert all(k in nb for k in range(c[v])) or c[v] == 0


def test_reference_vff_is_valid_and_keeps_the_palette():
    s, d, rp, cols = _graph(600, 0.03, 4)
    gff, c = greedy.greedy_ff(rp, cols), greedy.vff(rp, cols)
    assert quality.conflict_edges(torch.from_numpy(c), torch.from_numpy(s),
                                  torch.from_numpy(d)) == 0
    assert c.max() <= gff.max()


@pytest.mark.parametrize("name", ["greedy_ff", "vff"])
def test_reference_greedy_equals_the_program_on_the_cpu(name):
    from mcmc_colorer_tpu_torch.graph.container import Graph
    from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer
    from mcmc_colorer_tpu_torch.models.vff import VFFColorer

    s, d, rp, cols = _graph(900, 0.02, 8)
    g = Graph.from_edges(900, s, d)
    cls = GreedyFFColorer if name == "greedy_ff" else VFFColorer
    got = cls(g, device="cpu").run().colors
    want = getattr(greedy, name)(rp, cols)
    assert np.array_equal(got, want)


def test_conflicts_and_palette():
    src, dst = torch.tensor([0, 1, 2]), torch.tensor([1, 2, 3])
    assert quality.conflict_edges(torch.tensor([0, 0, 1, 1]), src, dst) == 2
    assert quality.off_palette(np.array([0, 3, -1, 2]), 3) == 2
    assert quality.palette("mcmc", 1150, 4) == 287
    assert quality.palette("greedy_ff", 80) == 81
