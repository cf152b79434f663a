"""MCMC chain core: the packed-adjacency chain and the ELL (gather) chain.

Counterpart of ``mcmc_colorer_tpu/models/mcmc.py``: the proposal family
(``_proposal_q``), the inverse-CDF sample (``_sample_cdf``), the sweeps,
the Hastings reverse probability, the chain loops, the flat tailcut and
``MCMCColorer``.

- Packed chain (slice 1, ``models/mcmc_resident.py``): each sweep computes
  NC = A·onehot(colors) once (kernel K1 on the card) and reads occupancy,
  conflicts and proposal from it (``_sweep_matmul``).
- ELL chain (``MCMCColorer``): each sweep hands the neighbour ids and
  the colour vector to kernel K2, which gathers the colours itself
  (``_sweep_pallas_fused``, backend ``pallas``, one launch a sweep), or
  to its plain version in row bands (``_sweep``, backend ``xla``); the
  tailcut repairs what is left with kernel K3.  Backend
  ``matmul``/``packed`` runs the packed chain over a host graph: A is
  built on the card from the ELL (``ops/dense_adj.get_adjacency``).
- Both ELL layouts: every pass over the rows walks ``_row_blocks``, the
  flat ELL's row bands or, on the degree-bucketed layout
  (``layout="bucketed"``), each degree-class rectangle at its own width.
  So one function serves JAX's flat and bucketed pair: ``_conflict_edges``
  (``_conflict_edges_bucketed``), ``_sweep_pallas_fused`` (K2 once a
  rectangle a sweep on the card, ``_sweep_pallas_fused_bucketed``),
  ``_sweep`` (``_sweep_bucketed``), ``_reverse_logq``
  (``_reverse_logq_bucketed``) and ``_tailcut_body`` (K3 a band or a
  rectangle, ``_tailcut_body_flat`` / ``_tailcut_body_bucketed``).

The JAX loops are ``lax.while_loop``s with a masked body; here they are
Python loops that read the body's conflict count to the host once per
body.  That read is the loop's exit test, so a loop stops exactly where
JAX's does, and draws exactly one uniform vector per body execution (a
second, scalar draw under Hastings), the final "done" body included.

Floating point: torch and XLA add float32 rows and prefix sums in
different orders, so ``q`` agrees to about 1e-7 relative and a vertex
whose uniform lies on a CDF step can pick the neighbouring colour.  The
integer parts (NC, occupancy, conflict counts, histograms, first fit,
the tailcut round) agree exactly.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from mcmc_colorer_tpu_torch.config import InitKind, MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.graph.container import (
    BucketedEll,
    EllGraph,
    Graph,
    degree_pad_for,
)
from mcmc_colorer_tpu_torch.models.base import (
    Coloring,
    bucketed_layout,
    colorer_device,
    colors_in_input_order,
)
from mcmc_colorer_tpu_torch.ops.dense_adj import (
    RESIDENT_BUDGET_BYTES,
    SWEEP_BLOCK_BYTES,
    get_adjacency,
    n_col_pad_of,
    neighbor_color_counts,
    resident_bytes,
)
from mcmc_colorer_tpu_torch.ops.neighbor import (
    color_histogram,
    neighbor_colors,
    occupancy_matrix,
)
from mcmc_colorer_tpu_torch.utils.rng import TorchUniformSource


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
    # torch.full, not torch.tensor: a fill kernel, no copy from the host
    # (which waits for the stream); a device divisor, not a CPU scalar
    # (which CUDA's division turns into a product by its reciprocal)
    frac = hist.to(f32) / torch.full((), float(n_nodes), dtype=f32, device=hist.device)
    return (1.0 - frac) / torch.full(
        (), float(max(n_colors - 1, 1)), dtype=f32, device=hist.device
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
    n_pad: int, n_nodes: int, params: MCMCParams, source, device, node_mask=None
) -> torch.Tensor:
    """Initial colouring (coloringMCMC_utils.cu:24-61) from ``n_pad``
    uniforms.  Phantom padding vertices (outside ``node_mask``, by default
    the ids from ``n_nodes`` on) get the out-of-palette colour nCol."""
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
    real = torch.arange(n_pad, device=device) < n_nodes if node_mask is None else node_mask
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


def _propose(cur, occ, taboo, unif, params: MCMCParams, p_eff, eps):
    """One block of a sweep from its occupancy: the proposal, the
    inverse-CDF sample and the taboo keep (``_sweep``'s block function,
    ``mcmc.py:844-868``).  ``occ`` may be wider than the palette (padded
    columns unoccupied, ``p_eff`` zero-padded to the same width).
    Returns (chosen, qstar, new_taboo)."""
    n_colors = params.n_colors
    q = _proposal_q(cur, occ, params, p_eff, eps, n_colors)
    chosen = _sample_cdf(q, unif, n_colors)
    qstar = q.gather(1, chosen.to(torch.int64)[:, None])[:, 0]
    taboo_active = taboo > 0
    chosen = torch.where(taboo_active, cur, chosen)
    qstar = torch.where(taboo_active, 1.0 - (n_colors - 1) * eps, qstar)
    new_taboo = torch.where(
        taboo_active, taboo - 1, (chosen == cur).to(torch.int32) * params.taboo_iterations
    )
    return chosen, qstar, new_taboo


def _reverse_q(occ, cur, star, n_colors: int, eps):
    """q(cur | star) per vertex from the occupancy of the STAR colouring,
    with the STANDARD formula for every variant, as the reference's
    lookOldColoring (coloringMCMC_standard.cu:88-135)."""
    f32 = torch.float32
    zn = occ.sum(1, dtype=torch.int32)
    zp = n_colors - zn
    move_q = torch.where(
        _at_color(occ, cur), eps, (1.0 - eps * zn.to(f32)) / zp.clamp(min=1).to(f32)
    )
    keep_q = torch.where(star == cur, 1.0 - (n_colors - 1) * eps, eps)
    q_old = torch.where(_at_color(occ, star), move_q, keep_q)
    return torch.where(zp == 0, 1.0, q_old)


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
    # conflict edges touch each endpoint once: Σ_i NC[i, c_i] = 2 E_conf
    conf2 = _at_color(nc, colors).sum()
    star = torch.empty_like(colors)
    new_taboo = torch.empty_like(taboo)
    logq = torch.zeros((), dtype=torch.float32, device=dev)
    for s in range(0, n_pad, block):
        e = min(s + block, n_pad)
        cur, real_b = colors[s:e], real[s:e]
        chosen, qstar, new_taboo[s:e] = _propose(
            cur, nc[s:e] > 0, taboo[s:e], unif[s:e], params, p_eff_pad, eps
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
    dev = colors.device
    eps = torch.tensor(params.epsilon, dtype=torch.float32, device=dev)
    col_valid = torch.arange(nc_star.shape[1], device=dev)[None, :] < params.n_colors
    real = torch.arange(n_pad, device=dev) < n_nodes
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for s in range(0, n_pad, block):
        e = min(s + block, n_pad)
        occ = (nc_star[s:e] > 0) & col_valid
        q_old = _reverse_q(occ, colors[s:e], star[s:e], params.n_colors, eps)
        q_old = torch.where(real[s:e], q_old, 1.0)
        total += torch.log(q_old.clamp(min=1e-30)).sum()
    return total


# ------------------------- ELL sweeps (gather) -------------------------

# Cap on the temporaries of one row band of an ELL pass (the plain sweep,
# conflict count, tailcut round, first fit).  A band of SB rows
# materialises the [SB, d_pad] int32 neighbour colours plus, in the plain
# passes, an int64 index of the same shape (torch's scatter and advanced
# indexing take int64 indices; the gathers use index_select, which takes
# the int32 ids as they are) and a few bool masks: _SLOT_BYTES per slot.
# 2 GiB of band temporaries is small beside the 80 GB card yet gives
# bands of ~100k rows at degree ~1300.  K2 gathers inside the kernel, so
# its sweep on the card needs no band.
_FUSED_NC_BYTES_CAP = 2 * 1024**3
_SLOT_BYTES = 4 + 8 + 4


def _fused_super_block(n_pad: int, d_pad: int) -> int:
    """Rows per band of an ELL pass: a multiple of 128 whose [SB, d_pad]
    temporaries stay under the cap (n_pad itself when it fits).  Bands
    may be ragged: torch slices need no divisor of n_pad."""
    cap_rows = _FUSED_NC_BYTES_CAP // max(d_pad * _SLOT_BYTES, 1)
    if n_pad <= cap_rows:
        return n_pad
    return max(128, cap_rows // 128 * 128)


def _bands(n_pad: int, d_pad: int):
    sb = _fused_super_block(n_pad, d_pad)
    for s in range(0, n_pad, sb):
        yield s, min(s + sb, n_pad)


def _row_blocks(ell, bands: bool = True, real_only: bool = False):
    """(start, neighbors) pieces covering the layout's rows in order: the
    flat ELL in row bands, or each rectangle of a ``BucketedEll`` in bands
    at its own width.  ``bands=False`` gives one piece a rectangle (K2's
    sweep on the card); ``real_only`` covers the real rows only (the flat
    ELL's first n_nodes, a slice's first n_real).  A piece is a row range
    of one contiguous rectangle, so its rows stay 16-byte aligned."""
    if isinstance(ell, BucketedEll):
        rects = [(s.start, s.neighbors, s.n_real) for s in ell.slices]
    else:
        rects = [(0, ell.neighbors, ell.n_nodes)]
    for start, neigh, n_real in rects:
        rows = n_real if real_only else neigh.shape[0]
        for s, e in _bands(rows, neigh.shape[1]) if bands else [(0, rows)]:
            yield start + s, neigh[s:e]


def _lookup_colors(ell, colors: torch.Tensor) -> torch.Tensor:
    """The colour vector K2 looks the neighbours up in: on a flat ELL the
    real vertices' (their ids come first, so at ER(100k, 0.01) K2 stages
    them in shared memory); on the bucketed layout the whole padded
    vector, since every slice keeps its own phantom tail (phantoms hold
    nCol, which counts nowhere, and are nobody's neighbour)."""
    return colors if isinstance(ell, BucketedEll) else colors[: ell.n_nodes]


def _conflict_edges(ell, colors: torch.Tensor) -> torch.Tensor:
    """Conflict edges of ``colors`` over either ELL layout (0-dim int64),
    counted a row block at a time."""
    ids = torch.arange(ell.n_pad, dtype=torch.int32, device=colors.device)
    total = torch.zeros((), dtype=torch.int64, device=colors.device)
    for s, neigh in _row_blocks(ell):
        e = s + neigh.shape[0]
        nc = neighbor_colors(neigh, colors)
        total += ((nc == colors[s:e, None]) & (neigh > ids[s:e, None])).sum()
    return total


def _ell_sweep(ell, params: MCMCParams, colors, taboo, unif, p_eff,
               eps, sweep_fn, bands: bool = True):
    """One full sweep over the real rows of either ELL layout:
    ``sweep_fn`` (K2 or its plain version) on each row band, or with
    ``bands=False`` once a rectangle (the flat ELL's real rows; each
    degree class's real rows, with ``row0`` its start); phantom rows keep
    their colour, with qstar 1 and taboo 0.  The neighbours are looked up
    in ``_lookup_colors``.  Returns (star, new_taboo, Σ log qstar,
    conflict edges of ``colors``)."""
    dev = colors.device
    eps_t = (eps.to(device=dev, dtype=torch.float32) if isinstance(eps, torch.Tensor)
             else torch.full((), params.epsilon if eps is None else eps,
                             dtype=torch.float32, device=dev))
    star = colors.clone()
    qstar = torch.ones((ell.n_pad,), dtype=torch.float32, device=dev)
    new_taboo = torch.zeros_like(taboo)
    conf = torch.zeros((), dtype=torch.int64, device=dev)
    lookup = _lookup_colors(ell, colors)
    for s, neigh in _row_blocks(ell, bands=bands, real_only=True):
        e = s + neigh.shape[0]
        st, qs, nt, cf = sweep_fn(
            neigh, lookup, colors[s:e], taboo[s:e], s, unif[s:e], p_eff, eps_t, params,
        )
        star[s:e], qstar[s:e], new_taboo[s:e] = st, qs, nt
        conf += cf
    logq = torch.log(qstar.clamp(min=1e-30)).sum()
    return star, new_taboo, logq, conf


def _sweep_pallas_fused(ell, params: MCMCParams, block: int, colors,
                        taboo, unif, p_eff, n_nodes: int | None = None, eps=None):
    """The ``pallas`` backend's sweep: kernel K2, which gathers the
    neighbour colours itself, with the conflict count of the CURRENT
    colouring fused in.  On the card it is one launch over the flat ELL's
    real rows, or one a degree-class rectangle of the bucketed layout;
    on the CPU its plain version runs in row bands.  Returns (star,
    new_taboo, Σ log qstar, conflicts).  ``block`` and ``n_nodes`` are
    unused (the ELL knows n_nodes); they keep the signature of
    ``_sweep_matmul``."""
    from mcmc_colorer_tpu_torch.ops.resample import resample_sweep

    return _ell_sweep(ell, params, colors, taboo, unif, p_eff, eps, resample_sweep,
                      bands=colors.device.type != "cuda")


def _sweep(ell, params: MCMCParams, block: int, colors, taboo, unif,
           p_eff, eps=None):
    """The ``xla`` backend's sweep, K2's plain version per row band.
    Returns (star, new_taboo, Σ log qstar), as JAX's ``_sweep``."""
    from mcmc_colorer_tpu_torch.ops.resample import resample_sweep_plain

    return _ell_sweep(
        ell, params, colors, taboo, unif, p_eff, eps, resample_sweep_plain
    )[:3]


def _reverse_logq(ell, params: MCMCParams, block: int, colors, star):
    """Σ log q(colors | star) for Hastings, from the occupancy of the STAR
    colouring over either ELL layout."""
    n_colors = params.n_colors
    dev = colors.device
    eps = torch.tensor(params.epsilon, dtype=torch.float32, device=dev)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for s, neigh in _row_blocks(ell):
        e = s + neigh.shape[0]
        occ = occupancy_matrix(neighbor_colors(neigh, star), n_colors)
        q_old = _reverse_q(occ, colors[s:e], star[s:e], n_colors, eps)
        q_old = torch.where(ell.node_mask[s:e], q_old, 1.0)
        total += torch.log(q_old.clamp(min=1e-30)).sum()
    return total


# ------------------------------- chain -------------------------------


@dataclass
class ChainState:
    """The chain's carry (JAX: colors, taboo, key, rip, conflicts, trace,
    done).  The key is the uniform source, held by the caller; the
    scalars and the trace live on the host, since the loops read the
    conflict count there every body."""

    colors: torch.Tensor     # [n_pad] int32
    taboo: torch.Tensor      # [n_pad] int32
    rip: int                 # iterations done
    conf_last: int           # conflicts measured by the last body
    trace: np.ndarray        # [max_iterations + 1] int32, -1 = unwritten
    done: bool               # the do-while's exit flag


def _chain_init(n_pad: int, n_nodes: int, params: MCMCParams, source, device,
                ell=None, node_mask=None) -> ChainState:
    """Initial carry.  Without ``ell`` it is JAX's ``_chain_init`` with
    fused=True (the conflict count is a sentinel the first do-while body
    overwrites); with ``ell`` it is fused=False, for the generic loop: the
    conflict count of the initial colouring, recorded in trace[0].
    ``node_mask`` (or ``ell``'s) marks the real vertices."""
    if node_mask is None and ell is not None:
        node_mask = ell.node_mask
    colors = _init_colors(n_pad, n_nodes, params, source, device, node_mask)
    trace = np.full((params.max_iterations + 1,), -1, dtype=np.int32)
    conf = 2**30
    if ell is not None:
        conf = int(_conflict_edges(ell, colors))
        trace[0] = conf
    return ChainState(
        colors=colors,
        taboo=torch.zeros((n_pad,), dtype=torch.int32, device=device),
        rip=0,
        conf_last=conf,
        trace=trace,
        done=False,
    )


def _p_eff_of(colors, params: MCMCParams, n_nodes: int, node_mask):
    hist = None
    if _needs_histogram(params):
        hist = color_histogram(colors, params.n_colors, node_mask)
    return _variant_distribution(params, hist, n_nodes, colors.device)


def _chain_body(graph, state: ChainState, *, params: MCMCParams, block: int,
                n_nodes: int, source, sweep=None) -> ChainState:
    """One execution of the do-while body (``_chain_segment_matmul.body``
    and ``_chain_segment_fused.body``): measure the conflicts of the
    current colouring inside the sweep; at or below the threshold keep
    the colouring and stop, else take the proposal.  ``sweep`` is
    ``_sweep_matmul`` (default; ``graph`` is the packed A) or
    ``_sweep_pallas_fused`` (``graph`` is an ``EllGraph`` or a
    ``BucketedEll``).  Hastings runs
    only on the packed chain: ``MCMCColorer`` sends Hastings on the ELL
    through the generic loop, as JAX does."""
    sweep = sweep or _sweep_matmul
    n_pad = state.colors.shape[0]
    dev = state.colors.device
    colors = state.colors
    unif = source.next(n_pad)
    u_acc = source.next(1) if params.hastings else None
    real = (graph.node_mask if isinstance(graph, (EllGraph, BucketedEll))
            else torch.arange(n_pad, device=dev) < n_nodes)
    p_eff = _p_eff_of(colors, params, n_nodes, real)
    star, new_taboo, logq_star, conf_cur_t = sweep(
        graph, params, block, colors, state.taboo, unif, p_eff, n_nodes
    )[:4]
    conf_cur = int(conf_cur_t)  # host read: the do-while's exit test
    trace = state.trace
    trace[state.rip] = conf_cur  # in place: the host trace is the carry's
    if conf_cur <= params.tailcut_threshold(n_nodes):
        return ChainState(colors, state.taboo, state.rip, conf_cur, trace, True)
    if params.hastings:
        if sweep is not _sweep_matmul:
            raise ValueError("the do-while runs Hastings on the packed chain only")
        nc_star = neighbor_color_counts(graph, star, params.n_colors, real)
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


def _do_while(graph, state: ChainState, budget: int, *, params, block, n_nodes,
              source, sweep) -> ChainState:
    """Run do-while bodies until done, ``budget`` more iterations, or the cap."""
    limit = min(state.rip + budget, params.max_iterations)
    while not state.done and state.rip < limit:
        state = _chain_body(
            graph, state, params=params, block=block, n_nodes=n_nodes,
            source=source, sweep=sweep,
        )
    return state


def _chain_segment_matmul(adj, state: ChainState, budget: int, *,
                          params: MCMCParams, block: int, n_nodes: int,
                          source) -> ChainState:
    """The packed chain's do-while (K1 per sweep)."""
    return _do_while(adj, state, budget, params=params, block=block,
                     n_nodes=n_nodes, source=source, sweep=_sweep_matmul)


def _chain_segment_fused(ell, state: ChainState, budget: int, *,
                         params: MCMCParams, block: int, source) -> ChainState:
    """The ELL chain's do-while (K2 per sweep)."""
    return _do_while(ell, state, budget, params=params, block=block,
                     n_nodes=ell.n_nodes, source=source, sweep=_sweep_pallas_fused)


def _chain_final_conflicts(ell, state: ChainState) -> int:
    """Conflicts of the do-while's final colouring: a converged loop
    measured it in its last body; a loop that stopped at the cap holds
    the pre-swap count, so the final colouring is measured."""
    if state.done:
        return state.conf_last
    return int(_conflict_edges(ell, state.colors))


def _chain_body_generic(ell, state: ChainState, *, params: MCMCParams,
                        block: int, backend: str, source) -> ChainState:
    """One body of the generic loop (``_chain_segment.body``, backends
    ``xla`` and Hastings): sweep, count the star colouring's conflicts,
    accept (always, or by the Metropolis–Hastings test)."""
    n_pad = ell.n_pad
    dev = state.colors.device
    colors, conflicts = state.colors, state.conf_last
    unif = source.next(n_pad)
    u_acc = source.next(1) if params.hastings else None
    p_eff = _p_eff_of(colors, params, ell.n_nodes, ell.node_mask)
    if backend == "pallas":
        star, new_taboo, logq_star, _ = _sweep_pallas_fused(
            ell, params, block, colors, state.taboo, unif, p_eff
        )
    else:
        star, new_taboo, logq_star = _sweep(
            ell, params, block, colors, state.taboo, unif, p_eff
        )
    conf_star = int(_conflict_edges(ell, star))  # host read: the loop's test
    colors_next, conf_next = star, conf_star
    if params.hastings:
        logq_old = _reverse_logq(ell, params, block, colors, star)
        log_ratio = (
            -torch.tensor(params.lambda_, dtype=torch.float32, device=dev)
            * torch.tensor(float(conf_star - conflicts), dtype=torch.float32, device=dev)
            + logq_old
            - logq_star
        )
        if not bool(torch.log(u_acc[0].clamp(min=1e-30)) < log_ratio):
            colors_next, conf_next = colors, conflicts  # rejected
    rip = state.rip + 1
    state.trace[rip] = conf_next
    z = params.tailcut_threshold(ell.n_nodes)
    return ChainState(colors_next, new_taboo, rip, conf_next, state.trace, conf_next <= z)


def _chain_segment(ell, state: ChainState, budget: int, *,
                   params: MCMCParams, block: int, backend: str, source) -> ChainState:
    """The generic loop: bodies while the conflicts exceed the threshold,
    at most ``budget`` more iterations, never past the cap."""
    z = params.tailcut_threshold(ell.n_nodes)
    limit = min(state.rip + budget, params.max_iterations)
    while state.conf_last > z and state.rip < limit:
        state = _chain_body_generic(
            ell, state, params=params, block=block, backend=backend, source=source
        )
    return state


# ------------------------------ tailcut ------------------------------


def _tailcut_init(ell, colors, *, params: MCMCParams):
    """Relabel colours by ascending class size (a stable sort, as
    ``jnp.argsort``), so "first free colour in ascending-histogram order"
    becomes a smallest-index first fit (kernel K3).  Returns
    (colors_r, ordered); ``_tailcut_finish`` maps back."""
    n_colors = params.n_colors
    dev = colors.device
    hist = color_histogram(colors, n_colors, ell.node_mask)
    ordered = torch.argsort(hist, stable=True).to(torch.int32)
    rank = torch.zeros((n_colors + 1,), dtype=torch.int32, device=dev)
    rank[ordered.to(torch.int64)] = torch.arange(n_colors, dtype=torch.int32, device=dev)
    rank[n_colors] = n_colors
    colors_r = rank[colors.clamp(0, n_colors).to(torch.int64)]
    return torch.where(ell.node_mask, colors_r, n_colors), ordered


def _tailcut_finish(ell, colors_r, ordered, *, params: MCMCParams):
    """Map rank-space colours back through the class-size order."""
    n_colors = params.n_colors
    tail = torch.full((1,), n_colors, dtype=torch.int32, device=colors_r.device)
    ordered_ext = torch.cat([ordered, tail])
    out = ordered_ext[colors_r.clamp(0, n_colors).to(torch.int64)]
    return torch.where(ell.node_mask, out, n_colors)


def _tailcut_body(ell, carry, source, *, params: MCMCParams, block: int):
    """One tailcut round on ``carry`` = (colors_r, conflicts, rounds,
    done), in rank space, over either ELL layout (K3 once a row block: a
    band of the flat ELL, or a degree-class rectangle).  Conflicted
    vertices with a free colour (K3's first fit) and no lower-id such
    neighbour move to it; when the round can move nobody, the conflicted
    vertices take the round's random colours (the stall escape).
    ``conflicts`` is the count of the colouring the round starts from, and
    the round is the last when it is 0, as in JAX."""
    from mcmc_colorer_tpu_torch.ops.firstfit import first_fit

    cols_r, _, rounds, _ = carry
    n_pad = ell.n_pad
    n_colors = params.n_colors
    dev = cols_r.device
    ids = torch.arange(n_pad, dtype=torch.int32, device=dev)
    allow = torch.ones((n_colors,), dtype=torch.int32, device=dev)
    conf = torch.zeros((), dtype=torch.int64, device=dev)
    flags = torch.empty((n_pad,), dtype=torch.bool, device=dev)
    cand = torch.empty((n_pad,), dtype=torch.int32, device=dev)
    for s, neigh in _row_blocks(ell):
        e = s + neigh.shape[0]
        nc = neighbor_colors(neigh, cols_r)
        same = nc == cols_r[s:e, None]
        conf += (same & (neigh > ids[s:e, None])).sum()
        flags[s:e] = same.any(1)
        cand[s:e] = first_fit(neigh, cols_r, allow, n_colors)
    flags &= ell.node_mask
    cand = torch.where(ell.node_mask, cand, -1)
    movable = flags & (cand >= 0)
    movable_ext = torch.cat([movable, torch.zeros((1,), dtype=torch.bool, device=dev)])
    lower = torch.empty((n_pad,), dtype=torch.bool, device=dev)
    for s, neigh in _row_blocks(ell):
        e = s + neigh.shape[0]
        nb_movable = movable_ext.index_select(0, neigh.reshape(-1)).reshape(neigh.shape)
        lower[s:e] = (nb_movable & (neigh < ids[s:e, None])).any(1)
    active = movable & ~lower
    stalled = (conf > 0) & ~active.any()
    rnd = source.randint(n_pad, n_colors)
    new_r = torch.where(active, cand, torch.where(stalled & flags, rnd, cols_r))
    conf_i = int(conf)  # host read: the loop's exit test
    return new_r, conf_i, rounds + 1, conf_i == 0


def _tailcut_max_rounds(ell) -> int:
    return ell.n_nodes + 1000


def _tailcut_segment(ell, carry, source, budget: int, *,
                     params: MCMCParams, block: int):
    """Tailcut rounds until done, ``budget`` more rounds, or the cap."""
    limit = min(carry[2] + budget, _tailcut_max_rounds(ell))
    while not carry[3] and carry[2] < limit:
        carry = _tailcut_body(ell, carry, source, params=params, block=block)
    return carry


# ------------------------------ colorer ------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class MCMCColorer:
    """Balanced-colouring MCMC chain over a host ``Graph`` laid out as an
    ELL on ``device`` (counterpart of JAX's ``MCMCColorer``).

    ``backend``: ``pallas`` (kernel K2 per sweep, with the conflict count
    fused in), ``xla`` (K2's plain version and a separate conflict count,
    JAX's generic loop), ``matmul`` or ``packed`` (the same thing here:
    the packed chain, NC = A·onehot(colors) by kernel K1 a sweep over a
    bit-packed A built on the device from the ELL, Hastings included) or
    ``auto`` (= ``pallas``).  Hastings on the ELL runs the generic loop,
    with K2 under ``pallas``.  The tailcut's first fit is kernel K3 on
    CUDA tensors.  ``layout``: ``flat`` (one rectangle padded to the max
    degree) or ``bucketed`` (the graph relabelled by ascending degree, one
    rectangle a degree class of width ``128 · 4^k`` under ``pallas`` and
    ``8 · 4^k`` otherwise, as JAX's; K2 and K3 then launch once a class;
    not with ``matmul``, whose A already drops the degree padding).
    ``device``: the current CUDA device by default (``colorer_device``);
    the CPU only when asked for.
    """

    def __init__(
        self,
        graph: Graph,
        params: MCMCParams,
        block_size: int | None = None,
        backend: str = "auto",
        layout: str = "flat",
        device="cuda",
    ) -> None:
        if layout not in ("flat", "bucketed"):
            raise ValueError(f"unknown layout {layout!r}")
        if backend == "auto":
            backend = "pallas"
        if backend == "packed":  # the only adjacency the port builds
            backend = "matmul"
        if backend not in ("pallas", "xla", "matmul"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "matmul" and layout != "flat":
            raise ValueError(
                "backend='matmul' is flat-layout only (the packed adjacency already "
                "removes the degree-padding cost the bucketed layout exists to cut)"
            )
        self.graph = graph
        self.params = params
        self.backend = backend
        self.layout = layout
        self.device = colorer_device(device)
        self.block = block_size or choose_block_size(graph.n, params.n_colors)
        if backend == "matmul" and self.device.type == "cuda":
            n_pad = -(-max(graph.n, 1) // self.block) * self.block
            d_pad = -(-max(graph.max_degree, 1) // 8) * 8
            need = resident_bytes(n_pad, n_col_pad_of(params.n_colors)) + n_pad * d_pad * 4
            if need > RESIDENT_BUDGET_BYTES:
                raise ValueError(
                    f"the packed backend at n_pad={n_pad} needs {need / 1e9:.1f} GB "
                    f"> {RESIDENT_BUDGET_BYTES / 1e9:.1f} GB; use backend='pallas'"
                )
        t0 = time.perf_counter()
        self._perm = self._pos = None
        if layout == "bucketed":
            if block_size is None:
                self.block = min(self.block, 2048)
            self.ell, self._perm, self._pos = bucketed_layout(
                graph, descending=False, min_lane=128 if backend == "pallas" else 8,
                device=self.device,
            )
        else:
            self.ell = graph.to_ell(
                pad_nodes_to=self.block,
                pad_degree_to=degree_pad_for(graph, backend),
                device=self.device,
            )
        self.adj_stats: dict = {}
        self._adj = (
            get_adjacency(graph, self.ell, stats=self.adj_stats)
            if backend == "matmul" else None
        )
        _sync(self.device)
        self.setup_seconds = time.perf_counter() - t0
        self._fused = backend == "pallas" and not params.hastings

    def run(self, seed: int, repetition: int = 0) -> Coloring:
        if os.environ.get("MCMC_COLORER_TRACE", "") not in ("", "0", "false"):
            raise NotImplementedError(
                "the free-colour TRACE is not ported yet (ROADMAP.md Queue 1 item 5)"
            )
        params, ell, dev = self.params, self.ell, self.device
        source = TorchUniformSource(seed, repetition, dev)
        _sync(dev)
        t0 = time.perf_counter()
        if self._adj is not None:
            state = _chain_init(ell.n_pad, ell.n_nodes, params, source, dev)
            state = _chain_segment_matmul(
                self._adj, state, params.max_iterations, params=params,
                block=self.block, n_nodes=ell.n_nodes, source=source,
            )
            conflicts = _chain_final_conflicts(ell, state)
            sweeps = int((state.trace >= 0).sum())
        elif self._fused:
            state = _chain_init(ell.n_pad, ell.n_nodes, params, source, dev,
                                node_mask=ell.node_mask)
            state = _chain_segment_fused(
                ell, state, params.max_iterations, params=params,
                block=self.block, source=source,
            )
            conflicts = _chain_final_conflicts(ell, state)
            sweeps = int((state.trace >= 0).sum())
        else:
            state = _chain_init(ell.n_pad, ell.n_nodes, params, source, dev, ell=ell)
            state = _chain_segment(
                ell, state, params.max_iterations, params=params,
                block=self.block, backend=self.backend, source=source,
            )
            conflicts = state.conf_last
            sweeps = state.rip
        _sync(dev)
        chain_s = time.perf_counter() - t0
        colors = state.colors
        tc_rounds = 0
        if params.tailcut:
            colors_r, ordered = _tailcut_init(ell, colors, params=params)
            tc = _tailcut_segment(
                ell, (colors_r, conflicts, 0, False), source,
                _tailcut_max_rounds(ell), params=params, block=self.block,
            )
            colors = _tailcut_finish(ell, tc[0], ordered, params=params)
            conflicts, tc_rounds = tc[1], tc[2]
        out = colors_in_input_order(colors, self.graph.n, self._perm, self._pos)
        total_s = time.perf_counter() - t0
        rip = state.rip
        return Coloring(
            colors=out,
            n_colors=params.n_colors,
            iterations=rip,
            converged=conflicts == 0 or conflicts <= params.tailcut_threshold(self.graph.n),
            duration_ms=total_s * 1e3,
            conflict_trace=state.trace[: rip + 1].astype(np.int64),
            extra={
                "final_conflicts": conflicts,
                "max_iter_reached": rip >= params.max_iterations,
                "tailcut_rounds": tc_rounds,
                "sweeps": sweeps,
                "chain_seconds": chain_s,
                # the tailcut and the colours' readback
                "tailcut_seconds": total_s - chain_s,
                "setup_seconds": self.setup_seconds,
            },
        )
