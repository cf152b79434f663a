"""MCMC chain core: the packed-adjacency chain and the ELL (gather) chain.

Counterpart of ``mcmc_colorer_tpu/models/mcmc.py``: the proposal family
(``_proposal_q``), the inverse-CDF sample (``_sample_cdf``), the sweeps,
the Hastings reverse probability, the chain loops, the flat tailcut and
``MCMCColorer``.

- Packed chain (slice 1, ``models/mcmc_resident.py``): each sweep computes
  NC = A·onehot(colors) once (kernel K1 on the card) and reads occupancy,
  conflicts and proposal from it (kernel K4, ``ops/propose_nc.py``;
  ``_sweep_matmul``).
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
  (``_reverse_logq_bucketed``) and ``_tailcut_body`` (K3's tailcut
  call and the lower-movable kernel once a rectangle a round on the card,
  ``_tailcut_body_flat`` / ``_tailcut_body_bucketed``).  Each K2 call
  of a sweep runs in an ``mc.sweep.class`` span, each K3 tailcut call
  and lower-movable call of a round in an ``mc.tailcut.class`` span: one
  a rectangle on the card, one a row band of the plain versions.

The chain has a chain axis throughout: the carry (``ChainState``) holds
C chains' colours [C, n_pad], each sweep is one K1 or K2 launch for all
of them and each tailcut round one K3 launch a rectangle.  One chain is
C = 1 (``MCMCColorer.run``, the stepped chain, the resident chain); an
ensemble (``parallel/chains.py``, the resident ``run_ensemble``) is the
same code at C > 1, where JAX vmaps its device chain.

The JAX loops are ``lax.while_loop``s with a masked body; here they are
Python loops that read the body's conflict counts to the host once per
body.  That read is the loop's exit test, so a loop stops exactly where
JAX's does, and draws exactly one uniform vector per body execution (a
second, scalar draw under Hastings), the final "done" body included.  A
body runs for the chains whose loop condition holds (``running``, a host
mask, as a vmapped ``while_loop`` runs its body while any chain's holds
and keeps a finished chain's carry, key included, as it was): only they
draw (``utils/rng.ChainSources``) and only they change, so chain c of an
ensemble steps exactly as a run of chain c alone fed the same source.
``MCMCColorer.run`` drives them in segments (``utils/segmented.py``);
under TRACE each segment boundary prints the free-colour line
(``_free_color_stats``).

Floating point: torch and XLA add float32 rows and prefix sums in
different orders, so ``q`` agrees to about 1e-7 relative and a vertex
whose uniform lies on a CDF step can pick the neighbouring colour.  The
integer parts (NC, occupancy, conflict counts, histograms, first fit,
the tailcut round) agree exactly.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from mcmc_colorer_tpu_torch.config import InitKind, MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.graph.container import (
    BucketedEll,
    EllGraph,
    Graph,
    HashGraph,
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
    neighbor_colors_chains,
    occupancy_matrix,
)
from mcmc_colorer_tpu_torch.ops.propose_nc import propose_nc
from mcmc_colorer_tpu_torch.utils.rng import ChainSources, TorchUniformSource
from mcmc_colorer_tpu_torch.utils.spans import span


def choose_block_size(n: int, n_colors: int) -> int:
    """Vertex rows per sweep block, a power of two, so one [block, nCol]
    float32 temporary is about ``SWEEP_BLOCK_BYTES``.  Larger than the JAX
    package's 32 MB blocks: on the card a block of a torch pass (such as
    the Hastings reverse proposal) costs tens of kernel launches, so
    fewer, larger blocks keep launch overhead below the work; the memory
    bound is counted in ``ops/dense_adj.py``."""
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
    """x[..., i, colors[..., i]], zero (False) where the colour lies
    outside x's colour axis (the last); any leading (chain) axes."""
    width = x.shape[-1]
    inside = (colors >= 0) & (colors < width)
    got = x.gather(-1, colors.clamp(0, width - 1).to(torch.int64)[..., None])[..., 0]
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
    padding and get q = 0.  ``p_eff`` may also be [B, width], a row's own
    distribution (the rows of several chains)."""
    f32 = torch.float32
    if p_eff is not None and p_eff.dim() == 1:
        p_eff = p_eff[None, :]
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
        reminder = torch.where(occ, p_eff - eps, 0.0).sum(1)
        move_q = torch.where(free, p_eff + (reminder / zp_f)[:, None], eps)
    elif kind in (ProposalKind.DECREASE_LINE, ProposalKind.DECREASE_EXP):
        # reminder spread as exp(-λ·j) / Σ_{i<Zp} exp(-λ·i) over the j-th
        # free colour in index order (_decrease.cu:42-58)
        lam = torch.full((), params.lambda_, dtype=f32, device=occ.device)
        reminder = torch.where(occ, p_eff - eps, 0.0).sum(1)
        j = torch.cumsum(free.to(f32), dim=1) - 1.0
        if params.lambda_ == 0.0:
            w = torch.ones_like(j) / zp_f[:, None]
        else:
            denom_r = (1.0 - torch.exp(-lam * zp_f)) / (1.0 - torch.exp(-lam))
            w = torch.exp(-lam * j) / denom_r[:, None]
        move_q = torch.where(free, p_eff + reminder[:, None] * w, eps)
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
    """One full proposal sweep of every chain (colours [C, n_pad]): one
    K1 launch gives each chain's NC [C, n_pad, n_col_pad], one K4 launch
    the proposal of every chain's rows from it, and the conflict count
    beside it (``ops/propose_nc.py``; their plain versions on the CPU, the
    proposal a chain at a time in row blocks).  Returns (star, new_taboo,
    Σ log qStar [C], conflict edges of ``colors`` [C], NC) — the
    reference's selectStarColoringBalanceDynamic + conflictCounter pair
    (coloringMCMC_balance.cu:79-143, _utils.cu:103-119)."""
    n_pad = colors.shape[1]
    dev = colors.device
    real = torch.arange(n_pad, device=dev) < n_nodes
    with span("mc.sweep.nc"):
        nc = neighbor_color_counts(adj, colors, params.n_colors, real)
    # a fill on the card, not a copy of a host scalar (which waits for the stream)
    eps = torch.full((), params.epsilon, dtype=torch.float32, device=dev)
    with span("mc.sweep.propose"):
        # conflict edges touch each endpoint once: Σ_i NC[i, c_i] = 2 E_conf
        star, new_taboo, logq, conf2 = propose_nc(nc, colors, taboo, unif, real, p_eff, eps,
                                                  params, block)
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
    dev = colors.device
    eps = torch.full((), params.epsilon, dtype=torch.float32, device=dev)
    real = torch.arange(colors.shape[0], device=dev) < n_nodes
    return _reverse_logq_nc(nc_star, colors, star, real, params, block, eps)


def _reverse_logq_nc(nc_star, cur, star, real, params: MCMCParams, block: int, eps):
    """Σ log q(cur | star) over the rows of NC(star) [rows, n_col_pad]
    (``cur``, ``star`` and ``real`` [rows]: a whole A's rows or a rank's
    strip's), in row blocks; rows outside ``real`` count q = 1."""
    rows = cur.shape[0]
    dev = cur.device
    col_valid = torch.arange(nc_star.shape[1], device=dev)[None, :] < params.n_colors
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for s in range(0, rows, block):
        e = min(s + block, rows)
        occ = (nc_star[s:e] > 0) & col_valid
        q_old = _reverse_q(occ, cur[s:e], star[s:e], params.n_colors, eps)
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


def _row_blocks(ell, bands: bool = True, real_only: bool = False, chains: int = 1):
    """(start, neighbors) pieces covering the layout's rows in order: the
    flat ELL in row bands, or each rectangle of a ``BucketedEll`` in bands
    at its own width.  ``bands=False`` gives one piece a rectangle (K2's
    sweep on the card); ``real_only`` covers the real rows only (the flat
    ELL's first n_nodes, a slice's first n_real); ``chains`` divides a
    band's rows by the chains whose temporaries it holds at once.  A piece is a row range of one
    contiguous rectangle, so its rows stay 16-byte aligned."""
    if isinstance(ell, BucketedEll):
        rects = [(s.start, s.neighbors, s.n_real) for s in ell.slices]
    else:
        rects = [(0, ell.neighbors, ell.n_nodes)]
    for start, neigh, n_real in rects:
        rows = n_real if real_only else neigh.shape[0]
        for s, e in _bands(rows, neigh.shape[1] * chains) if bands else [(0, rows)]:
            yield start + s, neigh[s:e]


def _lookup_colors(ell, colors: torch.Tensor) -> torch.Tensor:
    """The colour vector K2 looks the neighbours up in (the last axis of
    ``colors``): on a flat ELL the real vertices' (their ids come first,
    so at ER(100k, 0.01) K2 stages them in shared memory); on the bucketed
    layout the whole padded vector, since every slice keeps its own
    phantom tail (phantoms hold nCol, which counts nowhere, and are
    nobody's neighbour)."""
    if isinstance(ell, BucketedEll):
        return colors
    return colors[..., : ell.n_nodes].contiguous()


def _conflict_edges(ell, colors: torch.Tensor) -> torch.Tensor:
    """[C] int64 conflict edges of each chain's colours (``colors`` [C,
    n_pad]) over either ELL layout, one gather a row block for all
    chains."""
    c = colors.shape[0]
    ids = torch.arange(ell.n_pad, dtype=torch.int32, device=colors.device)
    total = torch.zeros((c,), dtype=torch.int64, device=colors.device)
    for s, neigh in _row_blocks(ell, chains=c):
        e = s + neigh.shape[0]
        nc = neighbor_colors_chains(neigh, colors)
        total += ((nc == colors[:, s:e, None]) & (neigh > ids[s:e, None])[None]).sum((1, 2))
    return total


def _ell_sweep(ell, params: MCMCParams, colors, taboo, unif, p_eff,
               eps, sweep_fn, bands: bool = True):
    """One full sweep of every chain (colours, taboo, unif [C, n_pad];
    p_eff [C, n_colors] or None) over the real rows of either ELL layout:
    ``sweep_fn`` (K2 or its plain version, both taking the chain axis) on
    each row band, or with ``bands=False`` once a rectangle (the flat
    ELL's real rows; each degree class's real rows, with ``row0`` its
    start), for all chains at once; phantom rows keep their colour, with
    qstar 1 and taboo 0.  The neighbours are looked up in
    ``_lookup_colors``.  Returns (star, new_taboo, Σ log qstar [C],
    conflict edges of ``colors`` [C])."""
    c = colors.shape[0]
    dev = colors.device
    eps_t = (eps.to(device=dev, dtype=torch.float32) if isinstance(eps, torch.Tensor)
             else torch.full((), params.epsilon if eps is None else eps,
                             dtype=torch.float32, device=dev))
    star = colors.clone()
    qstar = torch.ones(colors.shape, dtype=torch.float32, device=dev)
    new_taboo = torch.zeros_like(taboo)
    conf = torch.zeros((c,), dtype=torch.int64, device=dev)
    lookup = _lookup_colors(ell, colors)
    for s, neigh in _row_blocks(ell, bands=bands, real_only=True, chains=c):
        e = s + neigh.shape[0]
        cur, tb, u = (colors[:, s:e].contiguous(), taboo[:, s:e].contiguous(),
                      unif[:, s:e].contiguous())
        with span("mc.sweep.class"):
            st, qs, nt, cf = sweep_fn(neigh, lookup, cur, tb, s, u, p_eff, eps_t, params)
        star[:, s:e], qstar[:, s:e], new_taboo[:, s:e] = st, qs, nt
        conf += cf
    logq = torch.log(qstar.clamp(min=1e-30)).sum(1)
    return star, new_taboo, logq, conf


def _sweep_pallas_fused(ell, params: MCMCParams, block: int, colors,
                        taboo, unif, p_eff, n_nodes: int | None = None, eps=None):
    """The ``pallas`` backend's sweep: kernel K2, which gathers the
    neighbour colours itself, with the conflict count of the CURRENT
    colouring fused in.  On the card it is one launch for all chains over
    the flat ELL's real rows, or one a degree-class rectangle of the
    bucketed layout; on the CPU its plain version runs in row bands.
    Returns (star, new_taboo, Σ log qstar, conflicts).  ``block`` and
    ``n_nodes`` are unused (the ELL knows n_nodes); they keep the
    signature of ``_sweep_matmul``."""
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
    """Σ log q(colors | star) of one chain for Hastings, from the
    occupancy of the STAR colouring over either ELL layout."""
    n_colors = params.n_colors
    dev = colors.device
    eps = torch.full((), params.epsilon, dtype=torch.float32, device=dev)
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
    """The carry of C chains (JAX: colors, taboo, key, rip, conflicts,
    trace, done; vmapped for an ensemble, C = 1 for one chain).  The keys
    are the chains' uniform sources (``utils/rng.ChainSources``), held by
    the caller; the scalars and the traces live on the host, one entry a
    chain, since the loops read the conflict counts there every body.
    ``bodies`` counts the bodies run, the clock of the segments
    (``utils/segmented.py``)."""

    colors: torch.Tensor     # [C, n_pad] int32
    taboo: torch.Tensor      # [C, n_pad] int32
    rip: np.ndarray          # [C] int64 iterations done
    conf_last: np.ndarray    # [C] int64 conflicts measured by the last body
    trace: np.ndarray | None  # [C, max_iterations + 1] int32, -1 = unwritten
    done: np.ndarray         # [C] bool: the do-while's exit flags
    bodies: int = 0


def _mask(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _select(mask, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` on the chains where the host mask (bools, one a chain) holds,
    ``b`` on the others.  A uniform mask (always, for one chain) copies
    nothing to the card: a copy from pageable host memory would wait for
    the stream."""
    if all(mask):
        return a
    if not any(mask):
        return b
    return torch.where(_mask(np.asarray(mask), a.device)[:, None], a, b)


def _chain_init(n_pad: int, n_nodes: int, params: MCMCParams, sources, device,
                ell=None, node_mask=None) -> ChainState:
    """Initial carry of every chain, each from its own source.  Without
    ``ell`` it is JAX's ``_chain_init`` with fused=True (the conflict
    count is a sentinel the first do-while body overwrites); with ``ell``
    it is fused=False, for the generic loop: the conflict count of the
    initial colouring, recorded in trace[:, 0].  ``node_mask`` (or
    ``ell``'s) marks the real vertices."""
    if node_mask is None and ell is not None:
        node_mask = ell.node_mask
    c = len(sources)
    colors = torch.stack([
        _init_colors(n_pad, n_nodes, params, src, device, node_mask) for src in sources.sources
    ])
    trace = np.full((c, params.max_iterations + 1), -1, dtype=np.int32)
    conf = np.full(c, 2**30, dtype=np.int64)
    if ell is not None:
        conf = _conflict_edges(ell, colors).cpu().numpy()
        trace[:, 0] = conf
    return ChainState(colors=colors, taboo=torch.zeros_like(colors),
                      rip=np.zeros(c, np.int64), conf_last=conf, trace=trace,
                      done=np.zeros(c, bool))


def _p_eff_of(colors, params: MCMCParams, n_nodes: int, node_mask):
    """One chain's p_eff [n_colors] from its histogram, or None (STANDARD)."""
    hist = None
    if _needs_histogram(params):
        hist = color_histogram(colors, params.n_colors, node_mask)
    return _variant_distribution(params, hist, n_nodes, colors.device)


def _p_eff(colors, params: MCMCParams, n_nodes: int, node_mask):
    """[C, n_colors] every chain's p_eff, each from its own histogram, or
    None for STANDARD."""
    rows = [_p_eff_of(colors[k], params, n_nodes, node_mask) for k in range(colors.shape[0])]
    if rows[0] is None:
        return None
    return rows[0][None] if len(rows) == 1 else torch.stack(rows)


def _chain_body(graph, st: ChainState, running: np.ndarray, *, params: MCMCParams,
                block: int, n_nodes: int, sources, sweep) -> ChainState:
    """One execution of the do-while body (``_chain_segment_matmul.body``
    and ``_chain_segment_fused.body``) by the chains with ``running``:
    measure the conflicts of the current colouring inside the sweep; a
    chain at or below the threshold keeps its colouring and is done, the
    others take the proposal.  Only the running chains draw and change.
    ``sweep`` is ``_sweep_matmul`` (``graph`` the packed A) or
    ``_sweep_pallas_fused`` (``graph`` an ``EllGraph`` or a
    ``BucketedEll``).  Hastings runs only on the packed chain:
    ``MCMCColorer`` sends Hastings on the ELL through the generic loop, as
    JAX does.  One host read: the conflict counts.  Its steps run in the
    spans ``mc.body.draw``, ``.p_eff``, ``.sweep`` and ``.read``."""
    c, n_pad = st.colors.shape
    dev = st.colors.device
    with span("mc.body.draw"):
        unif = sources.next(n_pad, running)
        u_acc = sources.next(1, running) if params.hastings else None
    with span("mc.body.p_eff"):
        real = (torch.arange(n_pad, device=dev) < n_nodes if sweep is _sweep_matmul
                else graph.node_mask)
        p_eff = _p_eff(st.colors, params, n_nodes, real)
    with span("mc.body.sweep"):
        star, new_taboo, logq_star, conf_t = sweep(
            graph, params, block, st.colors, st.taboo, unif, p_eff, n_nodes
        )[:4]
    with span("mc.body.read"):
        conf = conf_t.tolist()  # host read: the do-while's exit tests
    z = params.tailcut_threshold(n_nodes)
    # a Python loop over the chains: cheaper on the host than numpy's
    # array operations at the few chains an ensemble has
    rip, conf_last, done = st.rip.copy(), st.conf_last.copy(), st.done.copy()
    step = [False] * c
    for k, go in enumerate(running.tolist()):
        if go:
            st.trace[k, rip[k]] = conf[k]  # in place: the host trace is the carry's
            conf_last[k] = conf[k]
            done[k] = conf[k] <= z
            step[k] = conf[k] > z
    rip += step
    if params.hastings and any(step):
        if sweep is not _sweep_matmul:
            raise ValueError("the do-while runs Hastings on the packed chain only")
        nc_star = neighbor_color_counts(graph, star, params.n_colors, real)
        conf_star = _at_color(nc_star, star).sum(1) // 2
        logq_old = torch.stack([
            _reverse_logq_matmul(nc_star[k], params, block, st.colors[k], star[k], n_nodes)
            for k in range(c)
        ])
        del nc_star
        lam = torch.full((), params.lambda_, dtype=torch.float32, device=dev)
        log_ratio = -lam * (conf_star - conf_t).to(torch.float32) + logq_old - logq_star
        accept = torch.log(u_acc[:, 0].clamp(min=1e-30)) < log_ratio
        star = torch.where(accept[:, None], star, st.colors)
    return ChainState(_select(step, star, st.colors), _select(step, new_taboo, st.taboo),
                      rip, conf_last, st.trace, done, st.bodies + 1)


def _chain_body_generic(ell, st: ChainState, running: np.ndarray, *, params: MCMCParams,
                        block: int, backend: str, sources, eps=None) -> ChainState:
    """One body of the generic loop (``_chain_segment.body``, backends
    ``xla`` and Hastings) by the chains with ``running``: sweep, count the
    star colouring's conflicts, accept (always, or by the
    Metropolis–Hastings test).  It is also the stepped chain's body
    (``models/chain_api.py``, JAX ``_step_segment``), which passes ``eps``
    (the debugger's live ε; ``params.epsilon`` when None) and a carry
    without a trace (``trace`` None: nothing recorded).  One host read:
    the star's conflict counts, with the Hastings test's terms, which the
    host then compares in float32 as the card would."""
    c, n_pad = st.colors.shape
    unif = sources.next(n_pad, running)
    u_acc = sources.next(1, running) if params.hastings else None
    p_eff = _p_eff(st.colors, params, ell.n_nodes, ell.node_mask)
    sweep = _sweep_pallas_fused if backend == "pallas" else _sweep
    star, new_taboo, logq_star = sweep(ell, params, block, st.colors, st.taboo, unif, p_eff,
                                       eps=eps)[:3]
    conf_star_t = _conflict_edges(ell, star)
    if params.hastings:
        logq_old = torch.stack([_reverse_logq(ell, params, block, st.colors[k], star[k])
                                for k in range(c)])
        log_u = torch.log(u_acc[:, 0].clamp(min=1e-30))
        host = torch.stack([conf_star_t.to(torch.float64), logq_old.to(torch.float64),
                            logq_star.to(torch.float64), log_u.to(torch.float64)]).cpu().numpy()
        conf_star = host[0].astype(np.int64)  # host read: the loop's tests
        lo, ls, lu = (host[i].astype(np.float32) for i in (1, 2, 3))
        delta = (conf_star - st.conf_last).astype(np.float32)
        move = (running & (lu < np.float32(-params.lambda_) * delta + lo - ls)).tolist()
    else:
        conf_star = conf_star_t.tolist()  # host read: the loop's tests
        move = running.tolist()
    z = params.tailcut_threshold(ell.n_nodes)
    rip, conf_last, done = st.rip.copy(), st.conf_last.copy(), st.done.copy()
    for k, go in enumerate(running.tolist()):
        if not go:
            continue
        rip[k] += 1
        if move[k]:
            conf_last[k] = conf_star[k]
        if st.trace is not None:
            st.trace[k, rip[k]] = conf_last[k]
        done[k] = conf_last[k] <= z
    return ChainState(_select(move, star, st.colors), _select(running, new_taboo, st.taboo),
                      rip, conf_last, st.trace, done, st.bodies + 1)


def _running(st: ChainState, limit: np.ndarray, *, params: MCMCParams, n_nodes: int,
             fused: bool) -> np.ndarray:
    """The chains whose loop condition holds: not done (the do-while) or
    above the threshold (the generic loop), and below ``limit``."""
    go = ~st.done if fused else st.conf_last > params.tailcut_threshold(n_nodes)
    return go & (st.rip < limit)


def _chain_segment(graph, st: ChainState, budget: int, *, params: MCMCParams,
                   n_nodes: int, fused: bool, body, cap=None) -> ChainState:
    """Bodies (``body(graph, st, running)``) until no chain runs: each
    chain at most ``budget`` more iterations, never past ``cap`` (by
    default the iteration cap; JAX's ``limit = rip + budget``).  Every
    running chain advances one iteration a body or finishes, so a segment
    runs ``budget`` bodies unless every chain finishes first.  Each body
    runs in the span ``mc.body``."""
    limit = np.minimum(st.rip + budget, params.max_iterations if cap is None else cap)
    while True:
        running = _running(st, limit, params=params, n_nodes=n_nodes, fused=fused)
        if not running.any():
            return st
        with span("mc.body"):
            st = body(graph, st, running)


def _chain_final_conflicts(ell, st: ChainState) -> np.ndarray:
    """[C] conflicts of the do-while's final colourings: a converged chain
    measured its own in its last body; a chain that stopped at the cap
    holds the pre-swap count, so its final colouring is measured."""
    if st.done.all():
        return st.conf_last.copy()
    return np.where(st.done, st.conf_last, _conflict_edges(ell, st.colors).cpu().numpy())


def _free_color_stats(ell, colors, *, n_colors: int) -> tuple[int, int, float]:
    """(min, max, avg) free colours over the real vertices of one chain's
    CURRENT colouring, freeColors[i] = nCol − |{colours of N(i)}| (the
    reference's verbose getStatsFreeColors, coloringMCMC_prints.cu:117-131;
    JAX ``_free_color_stats``, ``mcmc.py:1475``): plain torch in row
    bands, as JAX computes it outside any kernel, and one host read."""
    dev = colors.device
    mn = torch.full((), n_colors + 1, dtype=torch.int64, device=dev)
    mx = torch.full((), -1, dtype=torch.int64, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for s, neigh in _row_blocks(ell):
        e = s + neigh.shape[0]
        free = n_colors - occupancy_matrix(neighbor_colors(neigh, colors), n_colors).sum(1)
        real = ell.node_mask[s:e]
        mn = torch.minimum(mn, torch.where(real, free, n_colors + 1).min())
        mx = torch.maximum(mx, torch.where(real, free, -1).max())
        total += torch.where(real, free, 0).sum()
    lo, hi, tot = torch.stack([mn, mx, total]).tolist()
    return lo, hi, tot / max(ell.n_nodes, 1)


def trace_free_colors(stats) -> None:
    """The reference's TRACE line of one segment's free-colour stats."""
    from mcmc_colorer_tpu_torch.utils import term

    mn, mx, avg = stats
    term.trace(f"Max Free Colors: {mx} - Min Free Colors: {mn} - AVG Free Colors: {avg:g}")


# ------------------------------ tailcut ------------------------------


def _tailcut_init(ell, colors, *, params: MCMCParams):
    """Relabel one chain's colours by ascending class size (a stable sort,
    as ``jnp.argsort``), so "first free colour in ascending-histogram
    order" becomes a smallest-index first fit (kernel K3).  Returns
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
    """Map one chain's rank-space colours back through the class-size order."""
    n_colors = params.n_colors
    tail = torch.full((1,), n_colors, dtype=torch.int32, device=colors_r.device)
    ordered_ext = torch.cat([ordered, tail])
    out = ordered_ext[colors_r.clamp(0, n_colors).to(torch.int64)]
    return torch.where(ell.node_mask, out, n_colors)


@dataclass
class TailcutState:
    """The tailcut carry of C chains (JAX's (colors_r, conflicts, rounds,
    done), vmapped for an ensemble)."""

    colors_r: torch.Tensor   # [C, n_pad] int32, rank space
    conflicts: np.ndarray    # [C]
    rounds: np.ndarray       # [C]
    done: np.ndarray         # [C] bool


def _tailcut_body(ell, tc: TailcutState, running: np.ndarray, sources, *,
                  params: MCMCParams) -> TailcutState:
    """One tailcut round of the chains with ``running``, in rank space,
    over either ELL layout.  Conflicted vertices with a free colour (K3's
    first fit) and no lower-id such neighbour move to it; when the round
    can move nobody, the conflicted vertices take the round's random
    colours (the stall escape).  ``conflicts`` is the count of the
    colouring the round starts from, and the round is the last when it is
    0, as in JAX.  Only the running chains draw and change.

    Two passes over the rows, each a row block at a time for all chains.
    The first is K3's tailcut call (``ops/firstfit.first_fit`` with
    ``flag``): the first fit, the conflict flag and the conflict count
    from one read of the ids.  The second is ``lower_movable``.  On the
    card each is one launch a rectangle (the flat ELL, or a degree class);
    the plain versions on the CPU go in row bands, which bound their
    temporaries."""
    from mcmc_colorer_tpu_torch.ops.firstfit import first_fit, lower_movable

    cols_r = tc.colors_r
    c, n_pad = cols_r.shape
    n_colors = params.n_colors
    dev = cols_r.device
    bands = dev.type != "cuda"
    conf = torch.zeros((c,), dtype=torch.int64, device=dev)
    flags = torch.empty((c, n_pad), dtype=torch.bool, device=dev)
    cand = torch.empty((c, n_pad), dtype=torch.int32, device=dev)
    for s, neigh in _row_blocks(ell, bands=bands, chains=c):
        with span("mc.tailcut.class"):
            first_fit(neigh, cols_r, None, n_colors, row0=s, out=cand, flag=flags, count=conf)
    flags &= ell.node_mask
    cand = torch.where(ell.node_mask, cand, -1)
    movable = flags & (cand >= 0)
    lower = torch.empty((c, n_pad), dtype=torch.bool, device=dev)
    for s, neigh in _row_blocks(ell, bands=bands, chains=c):
        with span("mc.tailcut.class"):
            lower_movable(neigh, movable, row0=s, out=lower)
    active = movable & ~lower
    stalled = (conf > 0) & ~active.any(1)
    rnd = sources.randint(n_pad, n_colors, running=running)
    new_r = torch.where(active, cand, torch.where(stalled[:, None] & flags, rnd, cols_r))
    with span("mc.tailcut.read"):
        conf_h = conf.cpu().numpy()  # host read: the loop's exit tests
    return TailcutState(_select(running, new_r, cols_r), np.where(running, conf_h, tc.conflicts),
                        tc.rounds + running, tc.done | (running & (conf_h == 0)))


def _tailcut_max_rounds(ell) -> int:
    return ell.n_nodes + 1000


def _tailcut(ell, colors: torch.Tensor, conflicts, sources, *, params: MCMCParams):
    """The flat or bucketed tailcut of C chains (JAX's ``_tailcut_init`` /
    ``_tailcut_segment`` / ``_tailcut_finish``, vmapped for an ensemble),
    every chain until it is done or at the round cap.  Returns (colours
    [C, n_pad], conflicts [C], rounds [C]).  Spans: ``mc.tailcut``, one
    ``mc.tailcut.round`` a round."""
    with span("mc.tailcut"):
        c = colors.shape[0]
        pairs = [_tailcut_init(ell, colors[k], params=params) for k in range(c)]
        tc = TailcutState(torch.stack([p[0] for p in pairs]), np.asarray(conflicts).copy(),
                          np.zeros(c, np.int64), np.zeros(c, bool))
        cap = _tailcut_max_rounds(ell)
        while True:
            running = ~tc.done & (tc.rounds < cap)
            if not running.any():
                break
            with span("mc.tailcut.round"):
                tc = _tailcut_body(ell, tc, running, sources, params=params)
        out = torch.stack([_tailcut_finish(ell, tc.colors_r[k], pairs[k][1], params=params)
                           for k in range(c)])
        return out, tc.conflicts, tc.rounds


# ------------------------------ colorer ------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class MCMCColorer:
    """Balanced-colouring MCMC chain over a host ``Graph`` laid out as an
    ELL on ``device`` (counterpart of JAX's ``MCMCColorer``), or over a
    ``HashGraph``, whose ELL kernel K5 builds on the device (flat layout,
    ``pallas`` or ``xla`` only: the others build from a host CSR).

    ``backend``: ``pallas`` (kernel K2 per sweep, with the conflict count
    fused in), ``xla`` (K2's plain version and a separate conflict count,
    JAX's generic loop), ``matmul`` or ``packed`` (the same thing here:
    the packed chain, NC = A·onehot(colors) by kernel K1 a sweep over a
    bit-packed A built on the device from the ELL, Hastings included) or
    ``auto`` (= ``pallas``).  Hastings on the ELL runs the generic loop,
    with K2 under ``pallas``.  The tailcut's first fit is kernel K3 on
    CUDA tensors.  ``layout``: ``flat`` (one rectangle padded to the max
    degree) or ``bucketed`` (the graph relabelled by ascending degree, one
    rectangle a degree class of width ``8 · 4^k`` under either backend:
    K2 and K3 take rows of any width, so JAX's 128-lane classes under
    ``pallas`` would only pad; K2 and K3 then launch once a class; not
    with ``matmul``, whose A already drops the degree padding).
    ``device``: the current CUDA device by default (``colorer_device``);
    the CPU only when asked for.
    """

    def __init__(
        self,
        graph: Graph | HashGraph,
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
        if isinstance(graph, HashGraph) and (layout != "flat" or backend == "matmul"):
            raise ValueError(
                f"a HashGraph has no host CSR, which layout={layout!r} with "
                f"backend={backend!r} builds from: use the flat layout with the 'pallas' "
                f"or 'xla' backend"
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
                graph, descending=False, min_lane=8, device=self.device)
        else:
            # a HashGraph's rectangle is built by K5, not from a host CSR:
            # rows padded to the largest block any palette picks at this n
            # (every block is a power of two that divides it), so the
            # colourers of a ratio sweep share one rectangle and one build
            self.ell = graph.to_ell(
                pad_nodes_to=(math.lcm(self.block, choose_block_size(graph.n, 1))
                              if isinstance(graph, HashGraph) else self.block),
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

    def run_chains(self, sources, on_segment=None):
        """Run C = ``len(sources)`` chains (``utils/rng.ChainSources``) in
        one carry to their ends, then the tailcut: every sweep and every
        tailcut round one batched launch for all chains.  The chains run in
        segments (``utils/segmented.py``), ``on_segment(state, ...)`` called
        after each.  Returns (carry, colours [C, n_pad] in the layout's
        order, conflicts [C], tailcut rounds [C], chain seconds, start
        time)."""
        params, ell, dev = self.params, self.ell, self.device
        _sync(dev)
        t0 = time.perf_counter()
        with span("mc.chain"):
            state, conflicts = self._chain(sources, on_segment)
            _sync(dev)
        chain_s = time.perf_counter() - t0
        colors, rounds = state.colors, np.zeros(len(sources), np.int64)
        if params.tailcut:
            colors, conflicts, rounds = _tailcut(ell, colors, conflicts, sources, params=params)
        return state, colors, conflicts, rounds, chain_s, t0

    def _chain(self, sources, on_segment):
        """``run_chains``' chain: (carry, conflicts [C] of its final
        colourings)."""
        from mcmc_colorer_tpu_torch.utils.segmented import drive_segments

        params, ell, dev = self.params, self.ell, self.device
        kw = dict(params=params, block=self.block, sources=sources)
        fused = self._adj is not None or self._fused
        if fused:
            graph, sweep = ((self._adj, _sweep_matmul) if self._adj is not None
                            else (ell, _sweep_pallas_fused))
            state = _chain_init(ell.n_pad, ell.n_nodes, params, sources, dev,
                                node_mask=ell.node_mask)
            body = partial(_chain_body, n_nodes=ell.n_nodes, sweep=sweep, **kw)
        else:
            graph = ell
            state = _chain_init(ell.n_pad, ell.n_nodes, params, sources, dev, ell=ell)
            body = partial(_chain_body_generic, backend=self.backend, **kw)
        cap = np.full(len(sources), params.max_iterations)
        state = drive_segments(
            lambda st, b: _chain_segment(graph, st, b, params=params, n_nodes=ell.n_nodes,
                                         fused=fused, body=body),
            state,
            lambda st: (st.bodies, not _running(st, cap, params=params, n_nodes=ell.n_nodes,
                                                fused=fused).any()),
            on_segment=on_segment,
        )
        conflicts = _chain_final_conflicts(ell, state) if fused else state.conf_last.copy()
        return state, conflicts

    def run(self, seed: int, repetition: int = 0, source=None) -> Coloring:
        """Colour the graph: ``run_chains`` with one chain.  Under TRACE
        (``MCMC_COLORER_TRACE`` or ``logger.conf``) each segment boundary
        prints the free-colour line and records it in
        ``extra["free_color_trace_segments"]``, on the flat ELL only, as in
        JAX.  ``source`` replaces the run's uniform source
        (``utils/rng.py``; an ensemble's chain c is this run fed chain c's
        source)."""
        from mcmc_colorer_tpu_torch.utils import term

        params, ell = self.params, self.ell
        fc_segments: list = []

        def on_segment(st, *_):
            fc_segments.append(_free_color_stats(ell, st.colors[0], n_colors=params.n_colors))
            trace_free_colors(fc_segments[-1])

        trace_free = term.trace_enabled() and isinstance(ell, EllGraph)
        with span("mc.run.ell"):
            sources = ChainSources(
                [source or TorchUniformSource(seed, repetition, self.device)], self.device)
            state, colors, conflicts, rounds, chain_s, t0 = self.run_chains(
                sources, on_segment if trace_free else None)
            with span("mc.readback"):
                out = colors_in_input_order(colors[0], self.graph.n, self._perm, self._pos)
            total_s = time.perf_counter() - t0
        rip, conflicts = int(state.rip[0]), int(conflicts[0])
        return Coloring(
            colors=out,
            n_colors=params.n_colors,
            iterations=rip,
            converged=conflicts == 0 or conflicts <= params.tailcut_threshold(self.graph.n),
            duration_ms=total_s * 1e3,
            conflict_trace=state.trace[0, : rip + 1].astype(np.int64),
            extra={
                "final_conflicts": conflicts,
                "max_iter_reached": rip >= params.max_iterations,
                "tailcut_rounds": int(rounds[0]),
                "sweeps": state.bodies,
                "chain_seconds": chain_s,
                # the tailcut and the colours' readback
                "tailcut_seconds": total_s - chain_s,
                "setup_seconds": self.setup_seconds,
                # the layout's rectangles (K2 launches a sweep on the card)
                # and the neighbour ids a sweep reads
                "classes": len(ell.slices) if isinstance(ell, BucketedEll) else 1,
                "gather_ids": (ell.gather_elements if isinstance(ell, BucketedEll)
                               else ell.n_pad * ell.d_pad),
                **({"free_color_trace_segments": fc_segments} if fc_segments else {}),
            },
        )
