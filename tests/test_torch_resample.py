"""K2's plain version against the JAX package's Pallas kernel
``pallas_sweep`` (interpret mode on the CPU), fed the same numpy-made
state and the same p_eff: ``resample_sweep_reference`` over the gathered
band, and ``resample_sweep`` over neighbour ids and the colour vector
(on CPU tensors, the gather and then the reference).  Also K2's regime
choice (``sweep_shape``), a pure function of the shapes.

Tolerances, and why:

- conflicts, occupancy-derived counts: integer work, exact.
- star and new_taboo: the sampled colour comes from a float32 prefix sum
  that XLA and torch add in different orders (and the reminder row sum
  too), so a vertex whose uniform lies on a CDF step may pick the
  neighbouring colour.  They must be equal except at such boundary
  vertices: the uniform lies within 1e-5 (relative) of JAX's cdf at
  JAX's colour or the one before it, and at most 0.1 % of the vertices
  are such.
- qstar: float32 q at the chosen colour, rtol 1e-5 where the colours
  agree.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against the same plain version under the same rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.config import MCMCParams as JParams
from mcmc_colorer_tpu.config import ProposalKind as JKind
from mcmc_colorer_tpu.graph.generate import erdos_renyi as j_er
from mcmc_colorer_tpu.models import mcmc as jm
from mcmc_colorer_tpu.ops.neighbor import color_histogram as j_hist
from mcmc_colorer_tpu.ops.neighbor import neighbor_colors as j_nc
from mcmc_colorer_tpu.ops.neighbor import occupancy_matrix as j_occ
from mcmc_colorer_tpu.ops.pallas_resample import pallas_sweep

from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.interop import graph_from_jax
from mcmc_colorer_tpu_torch.ops import resample as k2
from mcmc_colorer_tpu_torch.ops.firstfit import PALETTE_MAX
from mcmc_colorer_tpu_torch.ops.neighbor import neighbor_colors

torch.set_num_threads(2)


def t(x):
    return torch.from_numpy(np.array(x))


def assert_boundary_only(star_t, star_j, unif, cdf_j, n_real):
    """Every vertex where the samples differ is a CDF-boundary vertex, and
    there are at most 0.1 % of them; returns their indices."""
    mism = np.flatnonzero(np.asarray(star_t) != np.asarray(star_j))
    assert mism.size <= 0.001 * n_real, f"{mism.size} sample mismatches"
    for v in mism:
        k, u = int(star_j[v]), float(unif[v])
        near = [abs(u - float(cdf_j[v, c])) <= 1e-5 * u for c in (k, k - 1) if c >= 0]
        assert any(near), f"vertex {v}: u={u} not on JAX's cdf step at colour {k}"
    return mism


def run_both(jg, n_colors, kind, taboo_iters, eps, seed, ids_form=False):
    """One sweep of JAX's kernel and of the port's plain version from the
    same state; checks the stated tolerances.  ``ids_form``: the port
    takes neighbour ids and the colour vector (``resample_sweep``, whose
    result must not change when the vector is cut to the real vertices,
    the only ids an ELL row holds besides the padding id), else the
    gathered band (``resample_sweep_reference``)."""
    g = graph_from_jax(jg)
    je = jg.to_ell(pad_nodes_to=128)
    te = g.to_ell(pad_nodes_to=128, device="cpu")
    n_pad = je.n_pad
    rng = np.random.default_rng(seed)
    colors = rng.integers(0, n_colors, n_pad).astype(np.int32)
    colors[jg.n:] = n_colors
    taboo = rng.integers(0, 2, n_pad).astype(np.int32)
    unif = rng.random(n_pad, dtype=np.float32)
    jp = JParams(n_colors=n_colors, proposal=JKind(kind.value),
                 taboo_iterations=taboo_iters, epsilon=eps)
    tp = MCMCParams(n_colors=n_colors, proposal=kind, taboo_iterations=taboo_iters,
                    epsilon=eps)
    hist = (j_hist(jnp.asarray(colors), n_colors, je.node_mask)
            if jm._needs_histogram(jp) else None)
    p_eff = jm._variant_distribution(jp, hist, jg.n)
    p_eff = (np.zeros(n_colors, np.float32) if p_eff is None
             else np.asarray(p_eff, dtype=np.float32))
    nc = np.asarray(j_nc(je.neighbors, jnp.asarray(colors)))
    star_j, qstar_j, taboo_j, conf_j = pallas_sweep(
        jnp.asarray(nc), je.neighbors, jnp.asarray(colors), jnp.asarray(taboo),
        jnp.asarray(unif), jnp.asarray(p_eff), jnp.float32(eps), params=jp,
        block=128, interpret=True,
    )
    nc_t = neighbor_colors(te.neighbors, t(colors))
    assert np.array_equal(nc_t.numpy(), nc)
    if ids_form:
        before = k2.launches
        rest = (t(colors), t(taboo), 0, t(unif), t(p_eff), eps, tp)
        star_t, qstar_t, taboo_t, conf_t = k2.resample_sweep(te.neighbors, t(colors), *rest)
        real_only = k2.resample_sweep(te.neighbors, t(colors[: jg.n]), *rest)
        assert k2.launches == before  # CPU tensors never reach the kernel
        for a, b in zip((star_t, qstar_t, taboo_t, conf_t), real_only):
            assert torch.equal(a, b)
    else:
        ids = torch.arange(n_pad, dtype=torch.int32)
        star_t, qstar_t, taboo_t, conf_t = k2.resample_sweep_reference(
            nc_t, te.neighbors, t(colors), t(taboo), ids, t(unif), t(p_eff), eps, tp
        )
    assert int(conf_t) == int(conf_j)
    # JAX's cdf: the XLA formulation, bit-identical to its kernel's
    occ = j_occ(jnp.asarray(nc), n_colors)
    q_j = jm._proposal_q(jnp.asarray(colors), occ, jp, jnp.asarray(p_eff),
                         eps=jnp.float32(eps))
    cdf_j = np.asarray(jnp.cumsum(q_j, axis=1))
    real = np.arange(n_pad) < jg.n
    star_j, taboo_j, qstar_j = (np.asarray(x)[real] for x in (star_j, taboo_j, qstar_j))
    mism = assert_boundary_only(star_t.numpy()[real], star_j, unif[real],
                                cdf_j[real], jg.n)
    keep = np.ones(jg.n, bool)
    keep[mism] = False
    assert np.array_equal(taboo_t.numpy()[real][keep], taboo_j[keep])
    np.testing.assert_allclose(qstar_t.numpy()[real][keep], qstar_j[keep], rtol=1e-5)
    return star_t


@pytest.mark.parametrize(
    "kind",
    [ProposalKind.STANDARD, ProposalKind.BALANCE_DYNAMIC, ProposalKind.DECREASE_EXP,
     ProposalKind.BALANCE_LINE],
)
@pytest.mark.parametrize("taboo_iters", [0, 3])
def test_reference_matches_pallas_sweep(medium_er, kind, taboo_iters):
    """Mirrors tests/test_pallas_resample.py:test_pallas_matches_xla_sweep."""
    run_both(medium_er, medium_er.max_degree, kind, taboo_iters, 1e-4, seed=5)


@pytest.mark.parametrize(
    "kind", [ProposalKind.STANDARD, ProposalKind.BALANCE_DYNAMIC, ProposalKind.DECREASE_EXP]
)
def test_reference_matches_pallas_sweep_wide_palette(kind):
    """Mirrors test_chunked_kernel_wide_palette_matches_xla: 4500 colours,
    which the TPU kernel walks in chunks and K2 serves in one pass."""
    jg = j_er(512, 0.05, seed=3, use_native=False)
    run_both(jg, 4500, kind, 2, 1e-6, seed=7)


KINDS = [ProposalKind.STANDARD, ProposalKind.BALANCE_DYNAMIC, ProposalKind.DECREASE_EXP,
         ProposalKind.BALANCE_LINE]
WIDE_KINDS = [ProposalKind.STANDARD, ProposalKind.BALANCE_DYNAMIC, ProposalKind.DECREASE_EXP]
IDS_CASES = ([("medium_er", kind, taboo) for kind in KINDS for taboo in (0, 3)]
             + [("wide", kind, 2) for kind in WIDE_KINDS])


@pytest.mark.parametrize("graph, kind, taboo_iters", IDS_CASES,
                         ids=[f"{g}-{k.value}-{tb}" for g, k, tb in IDS_CASES])
def test_ids_form_matches_pallas_sweep(request, graph, kind, taboo_iters):
    """``resample_sweep(neighbors, colors, ...)`` on CPU tensors against
    JAX's kernel fed ``colors[neighbors]``: the cases of the two tests
    above (phantoms hold colour n_colors, padding slots the id n_pad)."""
    if graph == "wide":
        run_both(j_er(512, 0.05, seed=3, use_native=False), 4500, kind, taboo_iters, 1e-6,
                 seed=7, ids_form=True)
    else:
        jg = request.getfixturevalue(graph)
        run_both(jg, jg.max_degree, kind, taboo_iters, 1e-4, seed=5, ids_form=True)


def test_reference_blocks_do_not_change_the_sweep(medium_er):
    """Row blocks of the plain version only bound memory."""
    g = graph_from_jax(medium_er)
    te = g.to_ell(pad_nodes_to=128, device="cpu")
    p = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.DECREASE_LINE,
                   taboo_iterations=2)
    rng = np.random.default_rng(2)
    colors = t(rng.integers(0, p.n_colors, te.n_pad).astype(np.int32))
    args = (neighbor_colors(te.neighbors, colors), te.neighbors, colors,
            t(rng.integers(0, 2, te.n_pad).astype(np.int32)),
            torch.arange(te.n_pad, dtype=torch.int32),
            t(rng.random(te.n_pad, dtype=np.float32)),
            t(np.full(p.n_colors, 1.0 / p.n_colors, np.float32)), p.epsilon, p)
    whole = k2.resample_sweep_reference(*args)
    blocked = k2.resample_sweep_reference(*args, block=128)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


def test_wrapper_checks():
    p = MCMCParams(n_colors=5)
    ids = torch.zeros((4, 8), dtype=torch.int32)
    colors = torch.zeros(16, dtype=torch.int32)
    v = torch.zeros(4, dtype=torch.int32)
    u = torch.zeros(4)
    with pytest.raises(TypeError, match="neighbors"):
        k2.resample_sweep(ids[0], colors, v, v, 0, u, None, 0.0, p)
    with pytest.raises(TypeError, match="colors"):
        k2.resample_sweep(ids, ids, v, v, 0, u, None, 0.0, p)
    with pytest.raises(TypeError, match="unif"):
        k2.resample_sweep(ids, colors, v, v, 0, v, None, 0.0, p)
    with pytest.raises(TypeError, match="p_eff"):
        k2.resample_sweep(ids, colors, v, v, 0, u, torch.zeros(4), 0.0, p)
    with pytest.raises(ValueError, match="row0"):
        k2.resample_sweep(ids, colors, v, v, -1, u, None, 0.0, p)
    with pytest.raises(ValueError, match="CUDA"):
        k2.resample_sweep_cuda(ids, colors, v, v, 0, u, None, 0.0, p)
    star, qstar, new_taboo, conf = k2.resample_sweep(ids, colors, v, v, 0, u, None, 0.0, p)
    assert star.dtype == new_taboo.dtype == torch.int32 and qstar.dtype == torch.float32
    assert conf.dim() == 0


@pytest.mark.parametrize("n_ids, n_colors, l2, want", [
    # ER(100k, 0.01)'s real vertices: staged, a full block of 32 warps
    (100_000, 1150, False, (True, 32, 4)),
    (100_000, 1150, True, (False, 8, 4)),       # forced to L2
    (1_000_000, 1173, False, (False, 8, 4)),    # config 3: the vector does not fit
    (500, 4500, False, (True, 32, 4)),          # the wide test palette
    (111_616, 1150, False, (True, 8, 4)),       # the longest vector with 4 mask copies,
    (111_624, 1150, False, (True, 15, 2)),      # then fewer copies (and so more warps),
    (113_344, 1150, False, (True, 8, 1)),       # down to one,
    (113_345, 1150, False, (False, 8, 4)),      # then L2
    (1_000, 46_084, False, (True, 8, 1)),       # the widest palette staged beside 1,000 ids
    (1_000, 46_085, False, (False, 8, 4)),
    (1_000, PALETTE_MAX, False, (False, 1, 1)),
])
def test_sweep_shape(n_ids, n_colors, l2, want):
    """K2's regime is a function of the vector's length, the palette and
    the shared-memory constants, and always fits a block's shared memory."""
    s = k2.sweep_shape(n_ids, n_colors, l2)
    assert (s.staged, s.warps, s.copies) == want
    n_words = (n_colors + 31) // 32
    masks = -(-s.warps * n_words * s.copies * 4 // 16) * 16
    staged = (-(-4 * n_colors // 16) + -(-2 * n_ids // 16)) * 16 if s.staged else 0
    assert s.smem_bytes == masks + staged <= k2.SMEM_BLOCK_BYTES
