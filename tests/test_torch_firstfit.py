"""K3's plain version (``ops/firstfit.py:first_fit_reference``) against the
JAX package's Pallas kernel ``pallas_first_fit`` (interpret mode on the
CPU), and the neighbour gathers that feed it.

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
from mcmc_colorer_tpu.ops.pallas_firstfit import pallas_first_fit, pallas_palette_ok

from mcmc_colorer_tpu_torch.interop import graph_from_jax
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
    te = g.to_ell(pad_nodes_to=128)
    max_colors = medium_er.max_degree + 1
    rng = np.random.default_rng(1)
    colors = rng.integers(-1, max_colors, te.n_pad).astype(np.int32)
    nc_j = np.asarray(j_neighbor_colors(je.neighbors, jnp.asarray(colors)))
    nc_t = neighbor_colors(te.neighbors, t(colors))
    return max_colors, colors, nc_j, nc_t


def test_gathers_match_jax(medium):
    max_colors, colors, nc_j, nc_t = medium
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
    """Mirrors tests/test_pallas_firstfit.py:test_first_fit_kernel_matches_xla."""
    max_colors, colors, nc_j, nc_t = medium
    allow = np.ones(max_colors, bool)
    if masked:
        allow[::7] = False
    cur = colors if with_cur else None
    want = pallas_first_fit(
        jnp.asarray(nc_j), jnp.asarray(allow), n_colors=max_colors, block=128,
        interpret=True, cur=None if cur is None else jnp.asarray(cur),
    )
    before = k3.launches
    got = k3.first_fit(nc_t, t(allow), max_colors, None if cur is None else t(cur))
    assert k3.launches == before  # CPU tensors never reach the kernel
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_first_fit_wide_palette_matches_jax():
    """Mirrors test_chunked_first_fit_wide_palette: 4500 colours, which the
    TPU kernel walks in chunks and K3 serves in one pass."""
    rng = np.random.default_rng(11)
    n_pad, d_pad, n_colors = 256, 40, 4500
    nc = rng.integers(-1, n_colors, size=(n_pad, d_pad), dtype=np.int32)
    allow = rng.integers(0, 2, size=(n_colors,), dtype=np.int32)
    allow[:64] = 0  # force some first fits deep into the palette
    cur = rng.integers(-1, n_colors, size=(n_pad,), dtype=np.int32)
    want = pallas_first_fit(
        jnp.asarray(nc), jnp.asarray(allow), n_colors=n_colors, block=128,
        cur=jnp.asarray(cur), interpret=True,
    )
    got = k3.first_fit(t(nc), t(allow), n_colors, t(cur))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() >= 64).sum() > 0


def test_first_fit_none_eligible():
    nc = torch.tensor([[0, 1, 2], [-1, -1, -1]], dtype=torch.int32)
    got = k3.first_fit(nc, torch.ones(3, dtype=torch.int32), 3, torch.tensor([1, 0], dtype=torch.int32))
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
    ones = torch.ones(5, dtype=torch.int32)
    with pytest.raises(TypeError):
        k3.first_fit(nc.to(torch.int64), ones, 5)
    with pytest.raises(ValueError, match="allow"):
        k3.first_fit(nc, ones[:4], 5)
    with pytest.raises(TypeError, match="cur"):
        k3.first_fit(nc, ones, 5, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        k3.first_fit_cuda(nc, ones, 5)
