"""MCMC chain core over the bit-packed adjacency.

Counterpart of the matmul-backend chain of ``mcmc_colorer_tpu/models/
mcmc.py``: the proposal family (``_proposal_q``), the inverse-CDF sample
(``_sample_cdf``), one sweep (``_sweep_matmul``), the Hastings reverse
probability (``_reverse_logq_matmul``), the initial carry
(``_chain_init``) and the budgeted do-while (``_chain_segment_matmul``).
Each sweep computes NC = A·onehot(colors) once (kernel K1 on the card)
and reads occupancy, conflicts and proposal from it.

The JAX loop is a ``lax.while_loop`` with a masked body; here it is a
Python loop that reads the sweep's conflict count to the host once per
body.  That read is the do-while's exit test, so the loop stops exactly
where JAX's does, and draws exactly one uniform vector per body
execution, the final "done" body included.

Floating point: torch and XLA add float32 rows and prefix sums in
different orders, so ``q`` agrees to about 1e-7 relative and a vertex
whose uniform lies on a CDF step can pick the neighbouring colour.  The
integer parts (NC, conflict counts, histograms) agree exactly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from mcmc_colorer_tpu_torch.config import InitKind, MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.ops.dense_adj import (
    SWEEP_BLOCK_BYTES,
    neighbor_color_counts,
)
from mcmc_colorer_tpu_torch.ops.neighbor import color_histogram


def choose_block_size(n: int, n_colors: int) -> int:
    """Vertex rows per sweep block, a power of two, so one [block, nCol]
    float32 temporary is about ``SWEEP_BLOCK_BYTES``.  Larger than the JAX
    package's 32 MB blocks: on the card each block costs some forty
    kernel launches, so fewer, larger blocks keep launch overhead below
    the work; the memory bound is counted in ``ops/dense_adj.py``."""
    b = SWEEP_BLOCK_BYTES // max(4 * n_colors, 1)
    b = max(128, min(1 << 16, b))
    b = 1 << int(math.floor(math.log2(b)))
    if n <= b:
        return max(128, 1 << int(math.ceil(math.log2(max(n, 8)))))
    return b


# ------------------ static per-run distributions (_utils.cu:5-21) ------------------


def distribution_line(n_colors: int, lambda_: float, device="cpu") -> torch.Tensor:
    idx = torch.arange(n_colors, dtype=torch.float32, device=device)
    w = float(n_colors) - torch.tensor(lambda_, dtype=torch.float32) * idx
    return w / w.sum()


def distribution_exp(n_colors: int, lambda_: float, device="cpu") -> torch.Tensor:
    idx = torch.arange(n_colors, dtype=torch.float32, device=device)
    w = torch.exp(-torch.tensor(lambda_, dtype=torch.float32) * idx)
    return w / w.sum()


def dynamic_distribution(hist: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """p_c = (1 - count_c / n) / (nCol - 1): emptier classes get more mass
    (genDynamicDistribution, coloringMCMC_utils.cu:64-70)."""
    n_colors = hist.shape[0]
    f32 = torch.float32
    frac = hist.to(f32) / torch.tensor(float(n_nodes), dtype=f32, device=hist.device)
    return (1.0 - frac) / torch.tensor(
        float(max(n_colors - 1, 1)), dtype=f32, device=hist.device
    )


# ------------------------------ proposal ------------------------------


def _at_color(x: torch.Tensor, colors: torch.Tensor) -> torch.Tensor:
    """x[i, colors[i]], zero (False) where the colour lies outside x's
    colour axis."""
    width = x.shape[1]
    inside = (colors >= 0) & (colors < width)
    got = x.gather(1, colors.clamp(0, width - 1).to(torch.int64)[:, None])[:, 0]
    return torch.where(inside, got, torch.zeros_like(got))


def _proposal_q(
    cur: torch.Tensor,          # [B] current colours
    occ: torch.Tensor,          # [B, width] neighbour-colour occupancy
    params: MCMCParams,
    p_eff: torch.Tensor | None,  # [width] variant distribution, 0-padded
    eps: torch.Tensor,          # float32 scalar
    n_colors: int,
) -> torch.Tensor:
    """[B, width] proposal probabilities (reference _standard.cu:50-58,
    _decrease.cu:50-58, _balance.cu:122-135).  Columns >= n_colors are
    padding and get q = 0."""
    f32 = torch.float32
    width = occ.shape[1]
    col_ids = torch.arange(width, dtype=torch.int32, device=occ.device)[None, :]
    col_valid = col_ids < n_colors
    free = ~occ & col_valid
    zn = occ.sum(1, dtype=torch.int32)
    zp = n_colors - zn
    zp_f = zp.clamp(min=1).to(f32)
    col_is_cur = col_ids == cur[:, None]
    keep_q = torch.where(col_is_cur, 1.0 - (n_colors - 1) * eps, eps)

    kind = params.proposal
    if kind == ProposalKind.STANDARD:
        move_q = torch.where(free, ((1.0 - eps * zn.to(f32)) / zp_f)[:, None], eps)
    elif kind in (
        ProposalKind.BALANCE_LINE,
        ProposalKind.BALANCE_EXP,
        ProposalKind.BALANCE_DYNAMIC,
    ):
        # reminder = Σ_occupied (p_eff − ε), spread uniformly over the free
        # colours (_balance.cu:29-33,122-128)
        reminder = torch.where(occ, p_eff[None, :] - eps, 0.0).sum(1)
        move_q = torch.where(free, p_eff[None, :] + (reminder / zp_f)[:, None], eps)
    elif kind in (ProposalKind.DECREASE_LINE, ProposalKind.DECREASE_EXP):
        # reminder spread as exp(-λ·j) / Σ_{i<Zp} exp(-λ·i) over the j-th
        # free colour in index order (_decrease.cu:42-58)
        lam = torch.tensor(params.lambda_, dtype=f32, device=occ.device)
        reminder = torch.where(occ, p_eff[None, :] - eps, 0.0).sum(1)
        j = torch.cumsum(free.to(f32), dim=1) - 1.0
        if params.lambda_ == 0.0:
            w = torch.ones_like(j) / zp_f[:, None]
        else:
            denom_r = (1.0 - torch.exp(-lam * zp_f)) / (1.0 - torch.exp(-lam))
            w = torch.exp(-lam * j) / denom_r[:, None]
        move_q = torch.where(free, p_eff[None, :] + reminder[:, None] * w, eps)
    else:  # pragma: no cover
        raise ValueError(f"unknown proposal {kind}")

    violating = _at_color(occ, cur)
    q = torch.where((violating & (zp > 0))[:, None], move_q, keep_q)
    # no free colour: keep the current one with probability 1 (_standard.cu:40-44)
    q = torch.where((zp == 0)[:, None], col_is_cur.to(f32), q)
    return torch.where(col_valid, q, 0.0)


def _sample_cdf(q: torch.Tensor, unif: torch.Tensor, n_colors: int) -> torch.Tensor:
    """Inverse-CDF walk: the first colour whose cumulative probability
    reaches the uniform; the last colour on overflow (_standard.cu:50-58)."""
    cdf = torch.cumsum(q, dim=1)
    chosen = (cdf < unif[:, None]).sum(1, dtype=torch.int32)
    return chosen.clamp(max=n_colors - 1)


def _init_colors(
    n_pad: int, n_nodes: int, params: MCMCParams, source, device
) -> torch.Tensor:
    """Initial colouring (coloringMCMC_utils.cu:24-61).  Phantom padding
    vertices get the out-of-palette colour nCol."""
    n_colors = params.n_colors
    u = source.next(n_pad)
    if params.init == InitKind.UNIFORM:
        colors = (u * n_colors).to(torch.int32).clamp(max=n_colors - 1)
    else:
        dist = (
            distribution_line(n_colors, params.lambda_, device)
            if params.init == InitKind.DISTRIBUTION_LINE
            else distribution_exp(n_colors, params.lambda_, device)
        )
        cdf = torch.cumsum(dist, 0)
        colors = (cdf[None, :] < u[:, None]).sum(1, dtype=torch.int32)
        colors = colors.clamp(max=n_colors - 1)
    real = torch.arange(n_pad, device=device) < n_nodes
    return torch.where(real, colors, n_colors)


def _variant_distribution(
    params: MCMCParams, hist: torch.Tensor | None, n_nodes: int, device="cpu"
) -> torch.Tensor | None:
    """Per-iteration p_eff[c], permuted the way the proposal reads it.
    BALANCE_LINE/EXP apply ``p_dist[argsort(hist)[c]]`` (a stable sort, as
    jnp.argsort); BALANCE_DYNAMIC indexes the dynamic distribution by
    colour (coloringMCMC_main.cu:130-133,192-198)."""
    kind = params.proposal
    if kind == ProposalKind.STANDARD:
        return None
    if kind == ProposalKind.DECREASE_LINE:
        return distribution_line(params.n_colors, params.lambda_, device)
    if kind == ProposalKind.DECREASE_EXP:
        return distribution_exp(params.n_colors, params.lambda_, device)
    if kind in (ProposalKind.BALANCE_LINE, ProposalKind.BALANCE_EXP):
        base = (
            distribution_line(params.n_colors, params.lambda_, device)
            if kind == ProposalKind.BALANCE_LINE
            else distribution_exp(params.n_colors, params.lambda_, device)
        )
        return base[torch.argsort(hist, stable=True)]
    if kind == ProposalKind.BALANCE_DYNAMIC:
        return dynamic_distribution(hist, n_nodes)
    raise ValueError(kind)


def _needs_histogram(params: MCMCParams) -> bool:
    return params.proposal in (
        ProposalKind.BALANCE_LINE,
        ProposalKind.BALANCE_EXP,
        ProposalKind.BALANCE_DYNAMIC,
    )


# ------------------------------- sweep -------------------------------


def _sweep_matmul(
    adj: torch.Tensor,
    params: MCMCParams,
    block: int,
    colors: torch.Tensor,
    taboo: torch.Tensor,
    unif: torch.Tensor,
    p_eff: torch.Tensor | None,
    n_nodes: int,
):
    """One full proposal sweep.  Returns (star, new_taboo, Σ log qStar,
    conflict edges of ``colors`` as a 0-dim int tensor, NC) —
    the reference's selectStarColoringBalanceDynamic + conflictCounter
    pair (coloringMCMC_balance.cu:79-143, _utils.cu:103-119)."""
    n_pad = colors.shape[0]
    n_colors = params.n_colors
    dev = colors.device
    real = torch.arange(n_pad, device=dev) < n_nodes
    nc = neighbor_color_counts(adj, colors, n_colors, real)
    n_col_pad = nc.shape[1]
    p_eff_pad = None
    if p_eff is not None:
        p_eff_pad = torch.zeros((n_col_pad,), dtype=torch.float32, device=dev)
        p_eff_pad[:n_colors] = p_eff
    eps = torch.tensor(params.epsilon, dtype=torch.float32, device=dev)
    keep_prob = 1.0 - (n_colors - 1) * eps
    # conflict edges touch each endpoint once: Σ_i NC[i, c_i] = 2 E_conf
    conf2 = _at_color(nc, colors).sum()
    star = torch.empty_like(colors)
    new_taboo = torch.empty_like(taboo)
    logq = torch.zeros((), dtype=torch.float32, device=dev)
    for s in range(0, n_pad, block):
        e = min(s + block, n_pad)
        cur, tab, real_b = colors[s:e], taboo[s:e], real[s:e]
        q = _proposal_q(cur, nc[s:e] > 0, params, p_eff_pad, eps, n_colors)
        chosen = _sample_cdf(q, unif[s:e], n_colors)
        qstar = q.gather(1, chosen.to(torch.int64)[:, None])[:, 0]
        taboo_active = tab > 0
        chosen = torch.where(taboo_active, cur, chosen)
        qstar = torch.where(taboo_active, keep_prob, qstar)
        new_taboo[s:e] = torch.where(
            taboo_active, tab - 1, (chosen == cur).to(torch.int32) * params.taboo_iterations
        )
        star[s:e] = torch.where(real_b, chosen, cur)
        qstar = torch.where(real_b, qstar, 1.0)
        logq += torch.log(qstar.clamp(min=1e-30)).sum()
    return star, new_taboo, logq, conf2 // 2, nc


def _reverse_logq_matmul(
    nc_star: torch.Tensor,   # [n_pad, n_col_pad] counts of the STAR colouring
    params: MCMCParams,
    block: int,
    colors: torch.Tensor,
    star: torch.Tensor,
    n_nodes: int,
) -> torch.Tensor:
    """Σ log q(colors | star) for Hastings, read from NC(star)
    (``_reverse_logq_matmul``)."""
    n_pad = colors.shape[0]
    n_colors = params.n_colors
    dev = colors.device
    f32 = torch.float32
    eps = torch.tensor(params.epsilon, dtype=f32, device=dev)
    col_valid = torch.arange(nc_star.shape[1], device=dev)[None, :] < n_colors
    real = torch.arange(n_pad, device=dev) < n_nodes
    total = torch.zeros((), dtype=f32, device=dev)
    for s in range(0, n_pad, block):
        e = min(s + block, n_pad)
        nc_blk, cur, st = nc_star[s:e], colors[s:e], star[s:e]
        zn = ((nc_blk > 0) & col_valid).sum(1, dtype=torch.int32)
        zp = n_colors - zn
        occ_star = _at_color(nc_blk, st) > 0
        occ_cur = _at_color(nc_blk, cur) > 0
        move_q = torch.where(
            occ_cur, eps, (1.0 - eps * zn.to(f32)) / zp.clamp(min=1).to(f32)
        )
        keep_q = torch.where(st == cur, 1.0 - (n_colors - 1) * eps, eps)
        q_old = torch.where(occ_star, move_q, keep_q)
        q_old = torch.where(zp == 0, 1.0, q_old)
        q_old = torch.where(real[s:e], q_old, 1.0)
        total += torch.log(q_old.clamp(min=1e-30)).sum()
    return total


# ------------------------------- chain -------------------------------


@dataclass
class ChainState:
    """The chain's carry (JAX: colors, taboo, key, rip, conflicts, trace,
    done).  The key is the uniform source, held by the caller; the
    scalars and the trace live on the host, since the do-while reads the
    conflict count there every body."""

    colors: torch.Tensor     # [n_pad] int32
    taboo: torch.Tensor      # [n_pad] int32
    rip: int                 # iterations done
    conf_last: int           # conflicts measured by the last body
    trace: np.ndarray        # [max_iterations + 1] int32, -1 = unwritten
    done: bool               # the do-while's exit flag


def _chain_init(n_pad: int, n_nodes: int, params: MCMCParams, source, device) -> ChainState:
    """Initial carry (``_chain_init`` with fused=True: the conflict count
    is a sentinel the first body overwrites)."""
    return ChainState(
        colors=_init_colors(n_pad, n_nodes, params, source, device),
        taboo=torch.zeros((n_pad,), dtype=torch.int32, device=device),
        rip=0,
        conf_last=2**30,
        trace=np.full((params.max_iterations + 1,), -1, dtype=np.int32),
        done=False,
    )


def _chain_body(adj, state: ChainState, *, params: MCMCParams, block: int,
                n_nodes: int, source) -> ChainState:
    """One execution of the do-while body (``_chain_segment_matmul.body``)."""
    n_pad = state.colors.shape[0]
    dev = state.colors.device
    colors = state.colors
    unif = source.next(n_pad)
    u_acc = source.next(1) if params.hastings else None
    hist = None
    if _needs_histogram(params):
        real = torch.arange(n_pad, device=dev) < n_nodes
        hist = color_histogram(colors, params.n_colors, real)
    p_eff = _variant_distribution(params, hist, n_nodes, dev)
    star, new_taboo, logq_star, conf_cur_t, _nc = _sweep_matmul(
        adj, params, block, colors, state.taboo, unif, p_eff, n_nodes
    )
    conf_cur = int(conf_cur_t)  # host read: the do-while's exit test
    trace = state.trace
    trace[state.rip] = conf_cur  # in place: the host trace is the carry's
    if conf_cur <= params.tailcut_threshold(n_nodes):
        return ChainState(colors, state.taboo, state.rip, conf_cur, trace, True)
    if params.hastings:
        real = torch.arange(n_pad, device=dev) < n_nodes
        nc_star = neighbor_color_counts(adj, star, params.n_colors, real)
        conf_star = _at_color(nc_star, star).sum() // 2
        logq_old = _reverse_logq_matmul(nc_star, params, block, colors, star, n_nodes)
        log_ratio = (
            -torch.tensor(params.lambda_, dtype=torch.float32, device=dev)
            * (conf_star - conf_cur).to(torch.float32)
            + logq_old
            - logq_star
        )
        accept = torch.log(u_acc[0].clamp(min=1e-30)) < log_ratio
        star = torch.where(accept, star, colors)
    return ChainState(star, new_taboo, state.rip + 1, conf_cur, trace, False)


def _chain_segment_matmul(adj, state: ChainState, budget: int, *,
                          params: MCMCParams, block: int, n_nodes: int,
                          source) -> ChainState:
    """Run bodies until done, ``budget`` more iterations, or the cap."""
    limit = min(state.rip + budget, params.max_iterations)
    while not state.done and state.rip < limit:
        state = _chain_body(
            adj, state, params=params, block=block, n_nodes=n_nodes,
            source=source,
        )
    return state
