"""K1's plain version and the port's NC dispatch against the JAX package.

NC is integer work: ``packed_nc_reference`` (the float32 product of 0/1
bits and a one-hot, exact because every partial sum is an integer below
2**24) and the CPU dispatch of ``neighbor_color_counts`` must equal JAX's
``packed_nc_pallas`` (interpret mode on the CPU) and
``neighbor_color_counts`` exactly.  The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.graph.generate import erdos_renyi
from mcmc_colorer_tpu.ops import dense_adj as jd
from mcmc_colorer_tpu.ops.pallas_bitmatmul import packed_nc_pallas

from mcmc_colorer_tpu_torch.interop import adjacency_from_jax
from mcmc_colorer_tpu_torch.ops import dense_adj as td
from mcmc_colorer_tpu_torch.ops import packed_nc as k1

torch.set_num_threads(2)

# the shapes of tests/test_matmul_backend.py:test_packed_nc_pallas_matches_dense:
# k-window padding, two k-windows with n_col_pad 1152, and a dense graph
SHAPES = [(1500, 0.05, 150), (4700, 0.01, 1100), (640, 0.3, 64)]


@pytest.mark.parametrize("n,p,ncol", SHAPES)
def test_packed_nc_matches_jax(n, p, ncol):
    g = erdos_renyi(n, p, seed=2)
    n_pad = (n + 127) // 128 * 128
    adj_j = jd.build_packed_adjacency(g, n_pad)
    rng = np.random.default_rng(n)
    colors = rng.integers(0, ncol, n_pad).astype(np.int32)
    colors[n:] = -1  # phantoms
    colors[rng.integers(0, n, 20)] = -1  # and a few masked real vertices
    n_col_pad = td.n_col_pad_of(ncol)

    want = np.asarray(packed_nc_pallas(adj_j, jnp.asarray(colors), n_col_pad))
    adj_t = adjacency_from_jax(np.asarray(adj_j))
    launches = k1.launches
    got = k1.packed_nc_reference(adj_t, torch.from_numpy(colors), n_col_pad)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(k1.packed_nc(adj_t, torch.from_numpy(colors), n_col_pad).numpy(), want)

    mask = np.arange(n_pad) < n
    colors_m = np.where(mask, colors, ncol).astype(np.int32)
    want_m = np.asarray(
        jd.neighbor_color_counts(adj_j, jnp.asarray(colors_m), ncol, jnp.asarray(mask))
    )
    got_m = td.neighbor_color_counts(
        adj_t, torch.from_numpy(colors_m), ncol, torch.from_numpy(mask)
    )
    assert got_m.shape == (n_pad, n_col_pad)
    assert np.array_equal(got_m.numpy(), want_m)
    assert k1.launches == launches  # CPU tensors never reach the kernel


def test_packed_nc_rejects_what_the_kernel_does_not_take():
    adj = torch.zeros((256, 128), dtype=torch.int32)
    col = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="n_col_pad"):
        k1.packed_nc(adj, col, 100)
    with pytest.raises(ValueError, match="words"):
        k1.packed_nc(torch.zeros((256, 64), dtype=torch.int32), col, 128)
    with pytest.raises(TypeError):
        k1.packed_nc(adj.to(torch.int64), col, 128)
    with pytest.raises(TypeError):
        k1.packed_nc(adj, col.to(torch.int64), 128)
    with pytest.raises(ValueError, match="colours"):
        k1.packed_nc(adj, torch.zeros(128 * 32 + 1, dtype=torch.int32), 128)
    with pytest.raises(ValueError, match="CUDA"):
        k1.packed_nc_cuda(adj, col, 128)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises with a message; it never falls back."""
    from mcmc_colorer_tpu_torch.utils import cuda_build

    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda _: False)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_library("packed_nc", k1.SOURCE)
    assert not (tmp_path / "kernels").exists()


def test_packed_bit_coords_and_word_count_match_jax():
    v = np.arange(0, 3 * 4096 + 17, 7)
    for a, b in zip(td.packed_bit_coords(v), jd.packed_bit_coords(v)):
        assert np.array_equal(a, b)
    for n_pad in (128, 4096, 4224, 100_352):
        assert td.packed_adj_words(n_pad) == jd.packed_adj_words(n_pad)
        assert td.packed_adj_bytes(n_pad) == jd.packed_adj_bytes(n_pad)


def test_packed_adj_max_n_follows_its_formula():
    """PACKED_ADJ_MAX_N is the largest multiple of 2048 whose resident
    bytes at a 2048-colour palette fit the budget."""
    m = td.PACKED_ADJ_MAX_N
    assert m % 2048 == 0
    assert td.resident_bytes(m, 2048) <= td.RESIDENT_BUDGET_BYTES
    assert td.resident_bytes(m + 2048, 2048) > td.RESIDENT_BUDGET_BYTES



@pytest.mark.parametrize("n_col_pad", [128, 1152, k1.N_COL_PAD_MAX])
def test_kernel_colour_vector(n_col_pad):
    """K1 reads colours as uint16, 0xFFFF where a colour counts nowhere
    (phantoms, masked vertices, colours past the palette)."""
    rng = np.random.default_rng(n_col_pad)
    colors = rng.integers(-3, n_col_pad + 3, 5000).astype(np.int32)
    got = k1._colors16(torch.from_numpy(colors), n_col_pad).numpy().view(np.uint16)
    keep = (colors >= 0) & (colors < n_col_pad)
    assert np.array_equal(got[keep], colors[keep]) and (got[~keep] == 0xFFFF).all()
    assert k1.N_COL_PAD_MAX < 0xFFFF and k1.N_COL_PAD_MAX % 128 == 0
    # a row of 16-bit counts of the widest palette fits beside the ring
    assert k1.RING_BYTES + 2 * k1.N_COL_PAD_MAX <= k1.SMEM_BLOCK_BYTES
