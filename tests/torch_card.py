"""The card of the tests marked ``card``, imported by the test files that
hold the port on an NVIDIA card the way ``cdf_boundary.py`` is.  Imports
neither JAX nor the JAX package: the card's machine has no JAX, so its
tests run there without ``conftest.py``::

    python -m pytest --noconftest -m card tests/test_torch_card_kernels.py \\
        tests/test_torch_card_colorers.py tests/test_torch_propose_nc.py \\
        tests/test_torch_hash_packed.py tests/test_torch_hash_ell.py
"""

from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from mcmc_colorer_tpu_torch.models.mcmc import _proposal_q
from mcmc_colorer_tpu_torch.ops import firstfit, hash_ell, hash_packed, packed_nc, propose_nc
from mcmc_colorer_tpu_torch.ops import resample
from mcmc_colorer_tpu_torch.ops.neighbor import occupancy_matrix

KERNELS = (packed_nc, resample, firstfit, propose_nc, hash_ell, hash_packed)  # K1-K6
# K2's and K4's sampled colour may differ from the plain version's only
# where the uniform lies within BOUNDARY_RTOL (relative) of the plain cdf
# at the plain colour or the one before it, at no more than this share of
# rows (one row on a shape of fewer than 1000)
BOUNDARY_RTOL, BOUNDARY_MAX_FRACTION = 1e-5, 1e-3


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, at run time).
    The first use builds every kernel of ``csrc/``, the nvcc runs started
    together; later uses find them loaded."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's CUDA kernels have no CPU mode")
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(lambda m: m.load_kernel(), KERNELS))
    return torch.device("cuda", 0)


def _on_cdf_steps(cdf, want_star, unif):
    """Every row's uniform ``unif`` lies within BOUNDARY_RTOL (relative) of
    its plain ``cdf`` at the plain colour ``want_star`` or the one before."""
    k = want_star.to(torch.int64)
    near = (unif - cdf.gather(1, k[:, None])[:, 0]).abs() <= BOUNDARY_RTOL * unif
    before = cdf.gather(1, (k - 1).clamp(min=0)[:, None])[:, 0]
    near |= (k >= 1) & ((unif - before).abs() <= BOUNDARY_RTOL * unif)
    assert bool(near.all()), "a sample differs off a CDF boundary"


def k2_agrees(got, want, args, params):
    """One chain's K2 outputs ``got`` against the plain version's ``want``
    on its ``args``: conflicts exact; samples equal but at CDF-boundary
    rows, at most BOUNDARY_MAX_FRACTION of them; new_taboo equal and
    qstar within 1e-5 (relative) where the samples agree."""
    neigh, colors, cur, _, _, unif, p_eff = args
    assert int(got[3]) == int(want[3])
    rows = neigh.shape[0]
    mism = (got[0] != want[0]).nonzero()[:, 0]
    assert mism.numel() <= max(1, BOUNDARY_MAX_FRACTION * rows)
    if mism.numel():
        occ = occupancy_matrix(resample.gathered_colors(neigh[mism], colors), params.n_colors)
        eps = torch.tensor(params.epsilon, dtype=torch.float32, device=neigh.device)
        cdf = torch.cumsum(_proposal_q(cur[mism], occ, params, p_eff, eps, params.n_colors),
                           dim=1)
        _on_cdf_steps(cdf, want[0][mism], unif[mism])
    keep = got[0] == want[0]
    assert torch.equal(got[2][keep], want[2][keep])
    rel = ((got[1] - want[1]).abs() / want[1].abs().clamp(min=1e-30))[keep]
    if rel.numel():
        assert float(rel.max()) <= 1e-5


def k4_agrees(got, want, args, chain):
    """Chain ``chain`` of K4's outputs ``got`` (star, new_taboo, qstar,
    conf2) against the plain version's ``want`` (star, new_taboo,
    Σ log qstar, conf2) on ``args``: conf2 exact; samples equal but at
    CDF-boundary rows, at most BOUNDARY_MAX_FRACTION of them; new_taboo
    equal where the samples agree, and Σ log qstar over those rows within
    1e-4 (relative): a boundary row's two colours have different q."""
    nc, cur, _, unif, _, p_eff, eps, params = args[:8]
    k, n_colors = chain, params.n_colors
    assert int(got[3][k]) == int(want[3][k])
    rows, n_col_pad = nc.shape[1:]
    mism = (got[0][k] != want[0][k]).nonzero()[:, 0]
    assert mism.numel() <= max(1, BOUNDARY_MAX_FRACTION * rows)
    logq_got = torch.log(got[2][k].clamp(min=1e-30)).sum()
    logq_want = want[2][k]
    if mism.numel():
        p_pad = None
        if p_eff is not None:
            p_pad = torch.zeros(n_col_pad, dtype=torch.float32, device=nc.device)
            p_pad[:n_colors] = p_eff[k]
        q = _proposal_q(cur[k][mism], nc[k][mism] > 0, params, p_pad, eps, n_colors)
        j = want[0][k][mism].to(torch.int64)
        _on_cdf_steps(torch.cumsum(q, dim=1), j, unif[k][mism])
        logq_got = logq_got - torch.log(got[2][k][mism].clamp(min=1e-30)).sum()
        logq_want = logq_want - torch.log(q.gather(1, j[:, None])[:, 0].clamp(min=1e-30)).sum()
    keep = got[0][k] == want[0][k]
    assert torch.equal(got[1][k][keep], want[1][k][keep])
    rel = float((logq_got - logq_want).abs() / logq_want.abs().clamp(min=1e-30))
    assert rel <= 1e-4, rel
