"""Sequential-semantics MCMC balanced colorer (numpy; a copy of
``mcmc_colorer_tpu/models/mcmc_sequential.py``, the same draws from
``np.random.default_rng(seed + repetition)``).

Faithful re-implementation of the reference CPU chain
(coloringMCMC_CPU.cpp, semantics in SURVEY §3.1): violating-*node* count
metric, per-node free-color scan, the STANDARD proposal formulas of
``fill_p`` (:393-481), pre-drawn per-node uniforms, taboo counters, and the
always-accept swap (the Hastings test is commented out in the reference,
:239-262).  The tailcut epilogue implements the *intended* greedy
(ascending-histogram first-free recolor) — the reference's inner loop has a
loop-variable bug (:296, SURVEY §9.1).

Round 3 adds the §3.1 step-5 machinery as a first-class option (VERDICT r2
item 5): ``fill_qstar`` (:532-551) computes the reverse-proposal
probability and ``params.hastings`` gates the swap with the reference's
(commented-out) acceptance test ``alpha = λ·(Cviol − Cstarviol) − Σlog q +
Σlog qstar`` (:238-262).  Two deliberate deviations, both documented
reference bugs: the reverse probability follows the GPU ``lookOldColoring``
formula (coloringMCMC_standard.cu:88-135 — the CPU ``fill_qstar`` tests
``freeCols[Cstar[i]]``, which is false for every violating node by
construction, collapsing qstar to ε), and the acceptance draw is a proper
``log u < α`` experiment (the commented ``bernie(min(α,0))`` compares a
uniform against a *log*-probability, which never rejects).

The per-iteration free-color stats (Zvcomp min/max/avg, the reference's
TRACE lines at :203-207 and coloringMCMC_prints.cu:117-131) are recorded
in ``extra['free_color_trace']`` and printed by the CLI TRACE path.

This model is the statistical golden reference for the device chain and
the ``--mcmccpu`` CLI algorithm.  It is intentionally plain numpy: clarity over
speed.
"""

from __future__ import annotations

import time

import numpy as np

from mcmc_colorer_tpu_torch.config import MCMCParams
from mcmc_colorer_tpu_torch.graph.container import Graph
from mcmc_colorer_tpu_torch.models.base import Coloring


class SequentialMCMCColorer:
    def __init__(self, graph: Graph, params: MCMCParams) -> None:
        self.graph = graph
        self.params = params

    def _violating(self, colors: np.ndarray) -> np.ndarray:
        """Per-node violation flags (violation_count, _CPU.cpp:329-351)."""
        g = self.graph
        u = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees)
        conflict = colors[u] == colors[g.cols]
        out = np.zeros(g.n, dtype=bool)
        np.logical_or.at(out, u[conflict], True)
        return out

    def _fill_qstar(
        self, new_colors: np.ndarray, old_colors: np.ndarray
    ) -> np.ndarray:
        """Reverse-proposal probability q*(C | Cstar) per node — the §3.1
        step-5 pass (fill_qstar, coloringMCMC_CPU.cpp:532-551) with the
        GPU ``lookOldColoring`` formula (coloringMCMC_standard.cu:88-135):
        occupancy is scanned under the NEW coloring and the probability of
        re-proposing the OLD color is recorded.  (The CPU fill_qstar
        instead tests the new color's own freeness, which is always false
        for violating nodes — a documented reference bug, see module
        docstring.)"""
        g, p = self.graph, self.params
        n_col = p.n_colors
        eps = p.epsilon
        qstar = np.empty(g.n, dtype=np.float64)
        for i in range(g.n):
            neigh = g.neighbors_of(i)
            occupied = np.zeros(n_col, dtype=bool)
            occupied[new_colors[neigh]] = True
            zv = int(occupied.sum())
            zvcomp = n_col - zv
            if zvcomp == 0:  # no free colors: q* = 1 (_standard.cu:109-112)
                qstar[i] = 1.0
            elif occupied[new_colors[i]]:  # violating under Cstar
                qstar[i] = (
                    eps
                    if occupied[old_colors[i]]
                    else (1.0 - eps * zv) / zvcomp
                )
            else:  # not violating: keep-current distribution
                qstar[i] = (
                    1.0 - (n_col - 1) * eps
                    if new_colors[i] == old_colors[i]
                    else eps
                )
        return qstar

    def run(self, seed: int, repetition: int = 0) -> Coloring:
        g, p = self.graph, self.params
        n, n_col = g.n, p.n_colors
        eps = p.epsilon
        rng = np.random.default_rng(seed + repetition)  # main.cu:171 pattern
        t0 = time.perf_counter()

        colors = rng.integers(0, n_col, size=n).astype(np.int64)
        taboo = np.zeros(n, dtype=np.int64)
        z = p.tailcut_threshold(n)
        trace = []
        free_trace = []  # per-iteration (min, max, avg) free colors
        accepts = 0
        rip = 0
        viols = self._violating(colors)
        n_viol = int(viols.sum())
        trace.append(n_viol)

        while n_viol > z and rip < p.max_iterations:
            rip += 1
            node_probab = rng.random(n)  # drawn up front (_CPU.cpp:139)
            new_colors = colors.copy()
            q = np.empty(n, dtype=np.float64)
            zvcomp_min, zvcomp_max, zvcomp_sum = n_col + 1, 0, 0
            for i in range(n):
                # the reference scans free colors and fills p for EVERY
                # node (the taboo check lives inside extract_new_color,
                # _CPU.cpp:183-204,495-501), so the Zvcomp stats include
                # taboo-frozen nodes
                neigh = g.neighbors_of(i)
                occupied = np.zeros(n_col, dtype=bool)
                occupied[colors[neigh]] = True
                zv = int(occupied.sum())
                zvcomp = n_col - zv
                zvcomp_min = min(zvcomp_min, zvcomp)
                zvcomp_max = max(zvcomp_max, zvcomp)
                zvcomp_sum += zvcomp
                if taboo[i] > 0:
                    # forced keep records the keep probability
                    # (extract_new_color taboo path, _CPU.cpp:495-501)
                    taboo[i] -= 1
                    new_colors[i] = colors[i]
                    q[i] = 1.0 - (n_col - 1) * eps
                    continue
                cur = colors[i]
                prob = np.empty(n_col, dtype=np.float64)
                if viols[i]:
                    if zvcomp == 0:
                        # all colors occupied: keep current w.h.p.
                        # (_CPU.cpp:402-411)
                        prob.fill(eps)
                        prob[cur] = 1.0 - (n_col - 1) * eps
                    else:
                        # free ← (1−ε·Zv)/Zvcomp, occupied ← ε (:414-420)
                        prob.fill(eps)
                        prob[~occupied] = (1.0 - eps * zv) / zvcomp
                else:
                    prob.fill(eps)
                    prob[cur] = 1.0 - (n_col - 1) * eps  # :471-479
                # inverse-CDF walk against the pre-drawn uniform (:493-528)
                cdf = np.cumsum(prob)
                c = int(np.searchsorted(cdf, node_probab[i], side="right"))
                if c >= n_col:
                    c = int(rng.integers(0, n_col))  # overflow guard (:521)
                new_colors[i] = c
                q[i] = prob[c]  # forward proposal prob (:524)
                if c == cur and p.taboo_iterations > 0:
                    taboo[i] = p.taboo_iterations  # :526-527
            free_trace.append(
                (zvcomp_min, zvcomp_max, zvcomp_sum / max(n, 1))
            )
            star_viols = self._violating(new_colors)
            n_star_viol = int(star_viols.sum())
            if p.hastings:
                # λ-weighted MH test over the node-violation metric
                # (_CPU.cpp:238-262, commented out there — SURVEY §9.2)
                qstar = self._fill_qstar(new_colors, colors)
                alpha = (
                    p.lambda_ * (n_viol - n_star_viol)
                    - np.log(np.maximum(q, 1e-300)).sum()
                    + np.log(np.maximum(qstar, 1e-300)).sum()
                )
                if np.log(max(rng.random(), 1e-300)) < alpha:
                    colors = new_colors
                    viols, n_viol = star_viols, n_star_viol
                    accepts += 1
            else:
                colors = new_colors
                viols, n_viol = star_viols, n_star_viol
                accepts += 1
            trace.append(n_viol)

        max_iter_reached = rip >= p.max_iterations
        if p.tailcut and n_viol > 0:
            colors = self._tailcut(colors, rng=rng)
            viols = self._violating(colors)
            n_viol = int(viols.sum())

        dur = (time.perf_counter() - t0) * 1e3
        return Coloring(
            colors=colors.astype(np.int32),
            n_colors=n_col,
            iterations=rip,
            converged=n_viol <= z,
            duration_ms=dur,
            conflict_trace=np.asarray(trace),
            extra={
                "final_violations": n_viol,
                "max_iter_reached": max_iter_reached,
                "free_color_trace": np.asarray(free_trace),
                "accepted_iterations": accepts,
            },
        )

    def _tailcut(self, colors: np.ndarray, rng=None) -> np.ndarray:
        """Intended tailcut (_CPU.cpp:272-311 semantics without the :296
        bug): visit violating nodes, recolor to the first free color in
        ascending-histogram order, until violation-free.

        With ``params.seq_stall_escape`` (opt-in), a pass that makes no
        progress — the no-free-color deadlock the matrix recorded at a
        0.2 stall rate for (p=0.04, ratio=4) — randomly re-colors the
        conflicting nodes and retries: the reference's own intended
        (dead-code) escape, unlock_stall
        (coloringMCMC_CPUutils.cpp:49-67), already realized for the
        device tailcut.  Default off: the faithful chain stalls exactly
        where the reference's would."""
        g, p = self.graph, self.params
        colors = colors.copy()
        hist = np.bincount(colors, minlength=p.n_colors)
        order = np.argsort(hist, kind="stable")
        prev_viol: int | None = None
        for _round in range(g.n + 1):
            viols = self._violating(colors)
            if not viols.any():
                break
            n_v = int(viols.sum())
            if (
                p.seq_stall_escape
                and rng is not None
                and prev_viol is not None
                and n_v >= prev_viol
            ):
                idx = np.flatnonzero(viols)
                colors[idx] = rng.integers(0, p.n_colors, size=idx.size)
                hist = np.bincount(colors, minlength=p.n_colors)
                order = np.argsort(hist, kind="stable")
                prev_viol = None
                continue
            prev_viol = n_v
            for i in np.flatnonzero(viols):
                neigh = g.neighbors_of(i)
                occupied = np.zeros(p.n_colors, dtype=bool)
                occupied[colors[neigh]] = True
                if occupied[colors[i]]:
                    for c in order:
                        if not occupied[c]:
                            colors[i] = c
                            break
        return colors
