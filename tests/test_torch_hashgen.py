"""The port's hash-defined graph against the JAX package's, exactly.

The packed words, the degrees and the edge sets are integer work, so
every comparison is exact.
"""

import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.ops import hashgen as jh

from mcmc_colorer_tpu_torch.graph import native
from mcmc_colorer_tpu_torch.interop import adjacency_to_jax
from mcmc_colorer_tpu_torch.ops import hashgen as th

torch.set_num_threads(2)

# (n, p, seed, n_pad, row_chunk): one window of 4096 columns, then two
CASES = [(700, 0.03, 13, 768, 256), (4200, 0.01, 3, 4352, 256)]


@pytest.mark.parametrize("n,p,seed,n_pad,row_chunk", CASES)
def test_packed_words_match_jax(n, p, seed, n_pad, row_chunk):
    want = np.asarray(jh.er_packed_on_device(n, p, seed, n_pad, row_chunk=row_chunk))
    adj = th.er_packed_on_device(n, p, seed, n_pad, row_chunk=row_chunk, device="cpu")
    got = adjacency_to_jax(adj)
    assert got.dtype == np.uint32 and got.shape == want.shape
    assert np.array_equal(got, want)
    deg_j = np.asarray(jh.degrees_from_packed(want))
    assert np.array_equal(th.degrees_from_packed(adj, row_chunk=300).numpy(), deg_j)


@pytest.mark.parametrize("n,p,seed", [(700, 0.03, 13), (300, 0.05, 5), (64, 0.9, 2**32 - 1)])
def test_edge_oracle_and_native_match_jax(n, p, seed):
    e_ref = jh.hash_edges_reference(n, p, seed)
    assert np.array_equal(th.hash_edges_reference(n, p, seed), e_ref)
    assert th.er_threshold(p) == jh.er_threshold(p)
    g = native.generate_er_hash(n, th.er_threshold(p), seed & 0xFFFFFFFF)
    u = np.repeat(np.arange(g.n), g.degrees)
    mask = u < g.cols
    e_cpp = np.stack([u[mask], g.cols[mask]], axis=1)
    e_cpp = e_cpp[np.lexsort((e_cpp[:, 1], e_cpp[:, 0]))]
    assert np.array_equal(e_cpp, e_ref)
    assert g.n_edges == e_ref.shape[0]


def test_popcount_and_mix_on_edge_patterns():
    """SWAR popcount and the int32 mixer on bit patterns with the sign bit
    set, against numpy's uint32 arithmetic."""
    vals = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xDEADBEEF, 0x55555555],
                    dtype=np.uint32)
    t = torch.from_numpy(vals.view(np.int32).copy())
    want = np.array([bin(int(v)).count("1") for v in vals])
    assert np.array_equal(th.popcount32(t).numpy(), want)
    i = torch.from_numpy(vals.view(np.int32).copy())
    j = torch.from_numpy(vals[::-1].view(np.int32).copy())
    got = th._mix(0xC0FFEE, i, j).numpy().view(np.uint32)
    want_mix = np.asarray(
        jh._mix(np.uint32(0xC0FFEE), vals, vals[::-1].copy())
    )
    assert np.array_equal(got, want_mix)


def test_generator_rejects_bad_bands():
    with pytest.raises(ValueError, match="row_chunk"):
        th.er_packed_on_device(100, 0.1, 1, 768, row_chunk=500, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        th.er_packed_on_device(1000, 0.1, 1, 768, row_chunk=256, device="cpu")
