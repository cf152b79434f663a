"""Kernel K4's wrapper, the proposal over NC (``ops/propose_nc.py``).

On the CPU ``propose_nc`` runs its plain version, which
``tests/test_torch_sweep.py:test_chains_sweep_matches_jax`` holds against
the JAX package's sweep at every proposal kind, one chain and three,
taboo off and on, and a palette off the 128-column grid.  Here: the
conflict count ``conf2``; phantom rows among the real ones, which keep
their colour at qstar 1 and leave the real rows' proposal as it is, in
row blocks that do not divide the rows; the wrapper's refusals of a wrong
dtype, rank, device or width; no launch on the CPU.

The case marked ``card`` holds the kernel against the plain version on
the card (``python -m pytest --noconftest -m card
tests/test_torch_propose_nc.py``: this file imports no JAX, which does
not run on the card): conf2 exact, the samples equal but at CDF-boundary
rows (``cdf_boundary.py``), new_taboo equal and Σ log qstar within 1e-4
relative where they agree, at palettes whose rows the kernel stages in
shared memory and one whose rows it reads in place.
"""

import numpy as np
import pytest
import torch

from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.models import mcmc as tm
from mcmc_colorer_tpu_torch.ops import propose_nc as k4
from mcmc_colorer_tpu_torch.ops.dense_adj import n_col_pad_of

from cdf_boundary import assert_boundary_only

torch.set_num_threads(2)

ROWS, BLOCK = 1000, 384  # ragged: 1000 rows in blocks of 384


def make_inputs(chains, n_colors, taboo_max, kind, seed, rows=ROWS, device="cpu",
                n_col_pad=None):
    """NC of a sparse random neighbourhood a row (a few rows with every
    colour taken) over ``n_col_pad`` columns (by default K1's padding of
    the palette), colours with phantom rows at the out-of-palette colour
    n_colors, taboo counters, uniforms and each chain's p_eff."""
    rng = np.random.default_rng(seed)
    n_col_pad = n_col_pad or n_col_pad_of(n_colors)
    nc = np.zeros((chains, rows, n_col_pad), np.int32)  # K1 leaves the padding at 0
    nc[:, :, :n_colors] = rng.binomial(3, 0.25, (chains, rows, n_colors))
    nc[:, ::97, :n_colors] += 1      # rows with no free colour
    real = rng.random(rows) > 0.05
    real[-37:] = False               # a padded tail, and phantoms among real rows
    cur = rng.integers(0, n_colors, (chains, rows)).astype(np.int32)
    cur[:, ~real] = n_colors
    taboo = rng.integers(0, taboo_max + 1, (chains, rows)).astype(np.int32)
    unif = rng.random((chains, rows), dtype=np.float32)
    params = MCMCParams(n_colors=n_colors, proposal=kind, taboo_iterations=taboo_max)
    hists = [torch.from_numpy(rng.integers(0, rows // 4, n_colors)) for _ in range(chains)]
    p_eff = None
    if kind != ProposalKind.STANDARD:
        p_eff = torch.stack([tm._variant_distribution(params, h, rows) for h in hists])
    t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    return (t(nc), t(cur), t(taboo), t(unif), t(real),
            None if p_eff is None else p_eff.to(device),
            torch.tensor(params.epsilon, dtype=torch.float32, device=device), params)


@pytest.mark.parametrize("chains", [1, 3])
@pytest.mark.parametrize("kind", list(ProposalKind))
def test_phantom_rows_keep_their_colour(kind, chains):
    """Rows outside ``real`` keep their colour at qstar 1; the real rows'
    samples and taboo are those of the same rows all taken as real, and
    Σ log qstar splits over the two kinds of row, each proposed alone."""
    nc, cur, taboo, unif, real, p_eff, eps, params = make_inputs(
        chains, 150, 4, kind, seed=chains * 10 + len(kind.value))
    star, new_taboo, logq, conf2 = k4.propose_nc(nc, cur, taboo, unif, real, p_eff, eps,
                                                 params, BLOCK)
    every = torch.ones_like(real)
    star_a, new_taboo_a, logq_a, conf2_a = k4.propose_nc(nc, cur, taboo, unif, every, p_eff,
                                                         eps, params, BLOCK)
    assert torch.equal(star[:, ~real], cur[:, ~real])
    assert torch.equal(star[:, real], star_a[:, real])
    assert torch.equal(new_taboo, new_taboo_a) and torch.equal(conf2, conf2_a)

    def alone(rows):
        sub = [x[:, rows].contiguous() for x in (nc, cur, taboo, unif)]
        return k4.propose_nc(*sub, every[rows], p_eff, eps, params, BLOCK)[2]

    torch.testing.assert_close(logq, alone(real), rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(logq_a, logq + alone(~real), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("chains", [1, 3])
def test_conf2_is_the_count_at_the_current_colours(chains):
    nc, cur, taboo, unif, real, p_eff, eps, params = make_inputs(
        chains, 150, 0, ProposalKind.BALANCE_DYNAMIC, seed=7)
    conf2 = k4.propose_nc(nc, cur, taboo, unif, real, p_eff, eps, params, BLOCK)[3]
    want = [sum(int(nc[k, i, cur[k, i]]) for i in range(ROWS) if cur[k, i] < nc.shape[2])
            for k in range(chains)]
    assert conf2.dtype == torch.int64 and conf2.tolist() == want
    assert torch.equal(conf2, tm._at_color(nc, cur).sum(1))


def _wrong(case, args):
    nc, cur, taboo, unif, real, p_eff = args
    meta = torch.device("meta")
    if case == "nc_dtype":
        nc = nc.float()
    elif case == "nc_rank":
        nc = nc[0]
    elif case == "cur_dtype":
        cur = cur.long()
    elif case == "unif_rank":
        unif = unif[0]
    elif case == "real_dtype":
        real = real.int()
    elif case == "p_eff_shape":
        p_eff = p_eff[:, 1:]
    elif case == "p_eff_missing":
        p_eff = None
    elif case == "cur_device":
        cur = torch.empty(cur.shape, dtype=cur.dtype, device=meta)
    elif case == "nc_device":
        nc, cur, taboo, unif, real, p_eff = (
            torch.empty(x.shape, dtype=x.dtype, device=meta)
            for x in (nc, cur, taboo, unif, real, p_eff))
    return nc, cur, taboo, unif, real, p_eff


@pytest.mark.parametrize("case, error", [
    ("nc_dtype", TypeError), ("nc_rank", TypeError), ("cur_dtype", TypeError),
    ("unif_rank", TypeError), ("real_dtype", TypeError), ("p_eff_shape", TypeError),
    ("p_eff_missing", ValueError), ("cur_device", ValueError), ("nc_device", ValueError),
])
def test_the_wrapper_refuses_wrong_inputs(case, error):
    nc, cur, taboo, unif, real, p_eff, eps, params = make_inputs(
        2, 150, 0, ProposalKind.BALANCE_DYNAMIC, seed=3, rows=256)
    args = _wrong(case, (nc, cur, taboo, unif, real, p_eff))
    with pytest.raises(error):
        k4.propose_nc(*args, eps, params, BLOCK)


def test_the_kernel_refuses_a_palette_too_wide():
    """K4 stages p_eff in a block's shared memory: a wider palette is
    refused before the launch, with the limit in the message."""
    nc, cur, taboo, unif, real, p_eff, eps, params = make_inputs(
        1, k4.N_COL_PAD_MAX + 1, 0, ProposalKind.BALANCE_DYNAMIC, seed=5, rows=8)
    with pytest.raises(ValueError, match=str(k4.N_COL_PAD_MAX)):
        k4.propose_nc_cuda(nc, cur, taboo, unif, real, p_eff, eps, params)


def test_the_kernel_refuses_cpu_tensors():
    nc, cur, taboo, unif, real, p_eff, eps, params = make_inputs(
        1, 24, 0, ProposalKind.STANDARD, seed=5, rows=256)
    with pytest.raises(ValueError, match="CUDA"):
        k4.propose_nc_cuda(nc, cur, taboo, unif, real, p_eff, eps, params)


def test_no_launch_on_the_cpu():
    before = k4.launches
    nc, cur, taboo, unif, real, p_eff, eps, params = make_inputs(
        3, 150, 4, ProposalKind.DECREASE_EXP, seed=9)
    k4.propose_nc(nc, cur, taboo, unif, real, p_eff, eps, params, BLOCK)
    assert k4.launches == before == 0


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K4 is a CUDA kernel with no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("n_colors, n_col_pad", [
    (24, None), (150, None), (1150, None), (2100, None),
    (2100, 30_080),  # rows wider than K4 stages in shared memory: read in place
])
@pytest.mark.parametrize("taboo_max", [0, 4])
@pytest.mark.parametrize("kind", list(ProposalKind))
def test_kernel_against_the_plain_version(card, kind, taboo_max, n_colors, n_col_pad):
    assert (n_col_pad or 0) <= k4.N_COL_PAD_MAX
    assert (n_col_pad or 0) > k4.N_COL_PAD_STAGED or n_col_pad is None
    rows = 4000
    nc, cur, taboo, unif, real, p_eff, eps, params = make_inputs(
        3, n_colors, taboo_max, kind, seed=n_colors + taboo_max, rows=rows, device=card,
        n_col_pad=n_col_pad)
    launches = k4.launches
    star, new_taboo, qstar, conf2 = k4.propose_nc_cuda(nc, cur, taboo, unif, real, p_eff, eps,
                                                       params)
    torch.cuda.synchronize()
    assert k4.launches == launches + 1
    want = k4.propose_nc_plain(nc, cur, taboo, unif, real, p_eff, eps, params, BLOCK)
    assert torch.equal(conf2, want[3])
    logq = torch.log(qstar.clamp(min=1e-30)).sum(1)
    n_col_pad = nc.shape[2]
    for k in range(3):
        p_pad = None
        if p_eff is not None:
            p_pad = torch.zeros(n_col_pad, device=card)
            p_pad[:n_colors] = p_eff[k]
        q = tm._proposal_q(cur[k], nc[k] > 0, params, p_pad, eps, n_colors)
        cdf = torch.cumsum(q, 1).cpu().numpy()
        mism = assert_boundary_only(star[k].cpu().numpy(), want[0][k].cpu().numpy(),
                                    unif[k].cpu().numpy(), cdf, rows)
        keep = np.ones(rows, bool)
        keep[mism] = False
        assert np.array_equal(new_taboo[k].cpu().numpy()[keep], want[1][k].cpu().numpy()[keep])
        # Σ log qstar over the rows where the samples agree: a boundary row's
        # two colours have different q
        m = torch.from_numpy(mism).to(card)
        q_plain = q[m, want[0][k][m].long()]
        got = float(logq[k] - torch.log(qstar[k][m].clamp(min=1e-30)).sum())
        ref = float(want[2][k] - torch.log(q_plain.clamp(min=1e-30)).sum())
        np.testing.assert_allclose(got, ref, rtol=1e-4)
