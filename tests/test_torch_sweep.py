"""One chain sweep of the PyTorch port against the JAX package's.

The same state (bit-packed A of a hash graph, colours, taboo counters,
uniforms), made with numpy, goes through JAX's ``_sweep_matmul`` and the
port's.  Tolerances, and why:

- NC, conflict counts and the colour histogram are integer work: exact.
- q is float32 built from row sums (``reminder``) whose order of
  addition is XLA's on one side and torch's on the other: rtol 1e-5,
  atol 1e-7.
- The sampled colour comes from a float32 prefix sum (XLA's
  ``reduce_window`` against ``torch.cumsum``), so a vertex whose uniform
  lies on a CDF step may pick the neighbouring colour.  star and
  new_taboo must be equal except at such boundary vertices: the uniform
  lies within 1e-5 (relative) of JAX's cdf at JAX's colour or the one
  before it.  At most 0.1 % of the vertices may be boundary vertices.
- Σ log qstar sums float32 logs in another order: rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.config import MCMCParams as JParams
from mcmc_colorer_tpu.config import ProposalKind as JKind
from mcmc_colorer_tpu.graph.container import EllGraph
from mcmc_colorer_tpu.models import mcmc as jm
from mcmc_colorer_tpu.ops import dense_adj as jd
from mcmc_colorer_tpu.ops import hashgen as jh
from mcmc_colorer_tpu.ops.neighbor import color_histogram as j_hist

from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.interop import adjacency_from_jax
from mcmc_colorer_tpu_torch.models import mcmc as tm
from mcmc_colorer_tpu_torch.ops import dense_adj as td
from mcmc_colorer_tpu_torch.ops.neighbor import color_histogram as t_hist

from cdf_boundary import assert_boundary_only

torch.set_num_threads(2)

N, P, GRAPH_SEED, N_PAD = 1200, 0.04, 21, 2048
JAX_BLOCK, TORCH_BLOCK = 512, 700  # the port's blocks are ragged on purpose


def jax_ell(degrees: np.ndarray) -> EllGraph:
    """The resident colorer's placeholder ELL (the matmul chain reads only A)."""
    return EllGraph(
        neighbors=jnp.full((N_PAD, 8), N_PAD, jnp.int32),
        degrees=jnp.asarray(degrees),
        n_nodes=N,
        n_edges=int(degrees.astype(np.int64).sum() // 2),
        max_degree=int(degrees.max()),
    )


@pytest.fixture(scope="module")
def graph():
    adj_j = jh.er_packed_on_device(N, P, GRAPH_SEED, N_PAD, row_chunk=N_PAD)
    deg = np.asarray(jh.degrees_from_packed(adj_j))
    return adj_j, adjacency_from_jax(np.asarray(adj_j)), jax_ell(deg)


def make_state(n_colors: int, taboo: int, seed: int):
    rng = np.random.default_rng(seed)
    colors = rng.integers(0, n_colors, N_PAD).astype(np.int32)
    colors[N:] = n_colors  # phantoms carry the out-of-palette colour
    tab = rng.integers(0, taboo + 1, N_PAD).astype(np.int32)
    unif = rng.random(N_PAD, dtype=np.float32)
    return colors, tab, unif


def jax_q(ell, nc, colors, params, p_eff, n_colors):
    """JAX's q and cdf for the state (what _sweep_matmul samples from)."""
    n_col_pad = nc.shape[1]
    p_pad = None
    if p_eff is not None:
        p_pad = jnp.zeros((n_col_pad,), jnp.float32).at[:n_colors].set(p_eff)
    q = jm._proposal_q(jnp.asarray(colors), nc > 0, params, p_pad, n_colors=n_colors)
    return np.asarray(q), np.asarray(jnp.cumsum(q, axis=1))


@pytest.mark.parametrize("n_colors", [24, 150])
@pytest.mark.parametrize("taboo", [0, 3])
@pytest.mark.parametrize("kind", list(ProposalKind))
def test_sweep_matches_jax(graph, kind, taboo, n_colors):
    adj_j, adj_t, ell = graph
    colors, tab, unif = make_state(n_colors, taboo, seed=n_colors + taboo)
    pj = JParams(n_colors=n_colors, proposal=JKind(kind.value), taboo_iterations=taboo)
    pt = MCMCParams(n_colors=n_colors, proposal=kind, taboo_iterations=taboo)

    hist_j = j_hist(jnp.asarray(colors), n_colors, ell.node_mask)
    real = torch.arange(N_PAD) < N
    hist_t = t_hist(torch.from_numpy(colors), n_colors, real)
    assert np.array_equal(np.asarray(hist_j), hist_t.numpy())
    p_eff_j = jm._variant_distribution(pj, hist_j, N)
    p_eff_t = tm._variant_distribution(pt, hist_t, N)
    if p_eff_j is None:
        assert p_eff_t is None
    else:
        # exp(-λ·c) reaches float32's subnormal range for wide palettes;
        # XLA on the CPU flushes subnormals to zero and torch keeps them
        np.testing.assert_allclose(
            p_eff_t.numpy(), np.asarray(p_eff_j), rtol=1e-6, atol=1.2e-38
        )

    star_j, taboo_j, logq_j, conf_j, nc_j = jm._sweep_matmul(
        ell, adj_j, pj, JAX_BLOCK, jnp.asarray(colors), jnp.asarray(tab),
        jnp.asarray(unif), p_eff_j,
    )
    # the port's sweep has a chain axis: one chain here
    star_t, taboo_t, logq_t, conf_t, nc_t = (x[0] for x in tm._sweep_matmul(
        adj_t, pt, TORCH_BLOCK, torch.from_numpy(colors)[None], torch.from_numpy(tab)[None],
        torch.from_numpy(unif)[None], None if p_eff_t is None else p_eff_t[None], N,
    ))
    assert np.array_equal(nc_t.numpy(), np.asarray(nc_j))
    assert int(conf_t) == int(conf_j)

    q_j, cdf_j = jax_q(ell, nc_j, colors, pj, p_eff_j, n_colors)
    p_pad = None
    if p_eff_t is not None:
        p_pad = torch.zeros(nc_t.shape[1])
        p_pad[:n_colors] = p_eff_t
    q_t = tm._proposal_q(
        torch.from_numpy(colors), nc_t > 0, pt, p_pad,
        torch.tensor(pt.epsilon, dtype=torch.float32), n_colors,
    )
    np.testing.assert_allclose(q_t.numpy(), q_j, rtol=1e-5, atol=1e-7)

    star_j, taboo_j = np.asarray(star_j), np.asarray(taboo_j)
    mism = assert_boundary_only(star_t.numpy(), star_j, unif, cdf_j, N)
    keep = np.ones(N_PAD, bool)
    keep[mism] = False
    assert np.array_equal(taboo_t.numpy()[keep], taboo_j[keep])
    np.testing.assert_allclose(float(logq_t), float(logq_j), rtol=1e-4)


@pytest.mark.parametrize("n_colors", [24, 150])
@pytest.mark.parametrize("taboo", [0, 4])
@pytest.mark.parametrize("chains", [1, 3])
@pytest.mark.parametrize("kind", list(ProposalKind))
def test_chains_sweep_matches_jax(graph, kind, chains, taboo, n_colors):
    """The port's sweep of C chains at once (one NC [C, n_pad, n_col_pad]
    and one proposal of every chain's rows, ``ops/propose_nc.py``'s plain
    version on the CPU) against JAX's sweep of each chain alone, with the
    phantom rows past N: NC and conflicts exact, the samples and taboo
    equal but at CDF-boundary vertices, Σ log qstar within 1e-4."""
    adj_j, adj_t, ell = graph
    pj = JParams(n_colors=n_colors, proposal=JKind(kind.value), taboo_iterations=taboo)
    pt = MCMCParams(n_colors=n_colors, proposal=kind, taboo_iterations=taboo)
    states = [make_state(n_colors, taboo, seed=1000 * k + n_colors + taboo)
              for k in range(chains)]
    colors, tab, unif = (np.stack(x) for x in zip(*states))
    real = torch.arange(N_PAD) < N
    p_eff_t = None
    if kind != ProposalKind.STANDARD:
        p_eff_t = torch.stack([
            tm._variant_distribution(pt, t_hist(torch.from_numpy(c), n_colors, real), N)
            for c in colors])
    star_t, taboo_t, logq_t, conf_t, nc_t = tm._sweep_matmul(
        adj_t, pt, TORCH_BLOCK, torch.from_numpy(colors), torch.from_numpy(tab),
        torch.from_numpy(unif), p_eff_t, N)
    assert tuple(nc_t.shape) == (chains, N_PAD, td.n_col_pad_of(n_colors))
    for k in range(chains):
        p_eff_j = jm._variant_distribution(
            pj, j_hist(jnp.asarray(colors[k]), n_colors, ell.node_mask), N)
        star_j, taboo_j, logq_j, conf_j, nc_j = jm._sweep_matmul(
            ell, adj_j, pj, JAX_BLOCK, jnp.asarray(colors[k]), jnp.asarray(tab[k]),
            jnp.asarray(unif[k]), p_eff_j,
        )
        assert np.array_equal(nc_t[k].numpy(), np.asarray(nc_j))
        assert int(conf_t[k]) == int(conf_j)
        _, cdf_j = jax_q(ell, nc_j, colors[k], pj, p_eff_j, n_colors)
        star_j, taboo_j = np.asarray(star_j), np.asarray(taboo_j)
        mism = assert_boundary_only(star_t[k].numpy(), star_j, unif[k], cdf_j, N)
        assert np.array_equal(star_t[k].numpy()[N:], colors[k][N:])  # phantoms keep theirs
        keep = np.ones(N_PAD, bool)
        keep[mism] = False
        assert np.array_equal(taboo_t[k].numpy()[keep], taboo_j[keep])
        np.testing.assert_allclose(float(logq_t[k]), float(logq_j), rtol=1e-4)


@pytest.mark.parametrize("n_colors", [24, 150])
def test_reverse_logq_matches_jax(graph, n_colors):
    """Hastings' reverse proposal probability, fed the same star colouring."""
    adj_j, adj_t, ell = graph
    colors, _, _ = make_state(n_colors, 0, seed=1)
    star, _, _ = make_state(n_colors, 0, seed=2)
    pj = JParams(n_colors=n_colors, hastings=True)
    pt = MCMCParams(n_colors=n_colors, hastings=True)
    nc_j = jd.neighbor_color_counts(adj_j, jnp.asarray(star), n_colors, ell.node_mask)
    real = torch.arange(N_PAD) < N
    nc_t = td.neighbor_color_counts(adj_t, torch.from_numpy(star), n_colors, real)
    assert np.array_equal(nc_t.numpy(), np.asarray(nc_j))
    rl_j = jm._reverse_logq_matmul(
        ell, nc_j, pj, JAX_BLOCK, jnp.asarray(colors), jnp.asarray(star)
    )
    rl_t = tm._reverse_logq_matmul(
        nc_t, pt, TORCH_BLOCK, torch.from_numpy(colors), torch.from_numpy(star), N
    )
    np.testing.assert_allclose(float(rl_t), float(rl_j), rtol=1e-5)


def test_choose_block_size_powers_of_two():
    """The port's vertex blocks are powers of two within [128, 65536] and
    cover small graphs in one block."""
    for n, c in [(1200, 77), (100_000, 1150), (10, 3), (500_000, 20_000)]:
        b = tm.choose_block_size(n, c)
        assert 128 <= b <= 1 << 16 and b & (b - 1) == 0
        if n <= b:
            assert b >= n
