"""Statistical validation over the reference's experimental matrix.

The reference's analysis scripts imply a (density p) x (numColRatio) grid
(``doVarCol3DGraph.py:40-50`` sweeps ratio 1-16 at p in {0.001, 0.005};
``doBalIdxgraph.py:110-115`` compares algorithms at the same densities).
This script runs that grid: the sequential reference-semantics chain
against the device chain (``MCMCColorer``, K2) on the STANDARD proposal,
plus the device chain on the BALANCE_DYNAMIC proposal (the 3-D surface's
configuration), across seeds, and records used colours, balance index,
convergence rate and iterations per cell.

Usage:

    python -m mcmc_colorer_tpu_torch.scripts.validate_matrix \
        [--n 4000] [--seeds 10] [--device cuda] \
        [--out build/torch_validate_matrix.json] [--plot build/torch_validate_matrix_3d.png]

``--patch`` recomputes the checks and the variant-effect measurement of
an existing report; ``--stall-escape-cell`` re-runs the sequential chain
of each cell that stalled with the stall escape on.  The plot is drawn
when matplotlib is there.  Exits 0 when every check holds, else 1.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from mcmc_colorer_tpu_torch.config import InitKind, MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.graph.generate import erdos_renyi
from mcmc_colorer_tpu_torch.models.base import check_coloring, colorer_device
from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
from mcmc_colorer_tpu_torch.models.mcmc_sequential import SequentialMCMCColorer
from mcmc_colorer_tpu_torch.scripts import BUILD_DIR, write_json

# at n=4000, p=0.04's max degree is ~210, so the palette stays >= ~13
# colours even at ratio 16: the regime where the balance proposals differ
# from standard (at nCol <= 3 the redistribution degenerates and the
# variants are bit-identical)
DENSITIES = (0.001, 0.005, 0.04)
RATIOS = (1.0, 2.0, 4.0, 8.0, 16.0)


def variant_effect(g, n_col, seeds, sweeps=3, device="cuda"):
    """Does the proposal machinery shape the sampled colourings?  From
    the reference's exp-skewed initial distribution (DISTRIBUTION_EXP_INIT,
    coloringMCMC.h:27-29) run ``sweeps`` sweeps of three variants and
    compare class-histogram stds.

    * STANDARD and BALANCE_DYNAMIC both target a flat histogram, so their
      stds must agree within noise: ``dynamic_matches_standard``.
    * DECREASE_EXP applies a fixed exp-sloped distribution over colour
      indices (initDistributionExp, _utils.cu:13-21) whose stationary
      histogram is skewed: it must separate decisively from standard,
      which shows the p_eff machinery reaches the sampled colours
      (``separates``)."""
    out = {}
    for prop in (ProposalKind.STANDARD, ProposalKind.BALANCE_DYNAMIC,
                 ProposalKind.DECREASE_EXP):
        params = MCMCParams(n_colors=n_col, proposal=prop, init=InitKind.DISTRIBUTION_EXP,
                            max_iterations=sweeps)
        colorer = MCMCColorer(g, params, device=device)
        stds = [colorer.run(seed=900 + s).class_stats()["std"] for s in range(seeds)]
        out[prop.value] = {"class_std_mean": float(np.mean(stds)),
                           "class_std_std": float(np.std(stds))}
    std_s, std_d, std_x = out["standard"], out["balance_dynamic"], out["decrease_exp"]
    out["dynamic_matches_standard"] = bool(
        abs(std_s["class_std_mean"] - std_d["class_std_mean"])
        <= 3 * (std_s["class_std_std"] + std_d["class_std_std"]) + 1.0
    )
    out["separates"] = bool(
        std_x["class_std_mean"] - std_s["class_std_mean"]
        > 3 * (std_x["class_std_std"] + std_s["class_std_std"])
    )
    return out


def cell_checks(c):
    """Per-cell equivalence verdicts (recomputable from stored stats).

    ``all_valid_when_converged`` binds the device chains only: the
    sequential chain reproduces the reference's tailcut semantics
    ('converged' means conflicts <= z, z = max(50, n/2000),
    coloringMCMC_CPU.cpp:89-97) and its repair loop has no stall escape
    (unlock_stall is dead code there), so a converged yet invalid
    sequential run at a tight palette is reference behaviour, recorded as
    ``sequential_stall_rate`` rather than failed."""
    s, d = c["sequential_standard"], c["device_standard"]
    both_converged = s["converged"] == 1.0 and d["converged"] == 1.0
    c["sequential_stall_rate"] = round(1.0 - s["valid"], 3) if s["converged"] else 0.0
    return {
        "device_converges_at_least_as_often": d["converged"] >= s["converged"],
        "all_valid_when_converged": (
            (d["converged"] < 1.0 or d["valid"] == 1.0)
            and (c["device_balance_dynamic"]["converged"] < 1.0
                 or c["device_balance_dynamic"]["valid"] == 1.0)
        ),
        "used_colors_within_15pct": not both_converged
        or abs(s["used_colors"] - d["used_colors"])
        <= 0.15 * max(s["used_colors"], d["used_colors"]),
        "balance_index_within_2std": not both_converged
        or abs(s["balance_index"] - d["balance_index"])
        <= 2 * (s["balance_index_std"] + d["balance_index_std"]) + 0.5,
    }


def cell(factory, g, p_edge, seeds):
    """One chain's means over ``seeds`` runs (seeds 500, 501, ...)."""
    rows = []
    for s in range(seeds):
        r = factory().run(seed=500 + s)
        rows.append({
            "used_colors": r.used_colors,
            "iterations": r.iterations,
            "balance_index": r.balance_index(p_edge),
            "converged": float(r.converged),
            "valid": float(check_coloring(g, r.colors)),
        })
    out = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    out["balance_index_std"] = float(np.std([r["balance_index"] for r in rows]))
    return out


def matrix_cell(g, p_edge, ratio, seeds, device="cuda"):
    """One cell of the grid on graph ``g``: the three chains, the checks
    and the variant effect."""
    # reference semantics: the flag divides the palette (main.cu:53
    # inverts it, :162 multiplies maxDeg by the inverse); at high ratio
    # and low density the palette shrinks to a handful of colours and runs
    # fail to converge: the counts the reference's checkNoConv* scripts
    # tabulate
    n_col = max(2, int(g.max_degree / ratio))
    params_std = MCMCParams(n_colors=n_col, proposal=ProposalKind.STANDARD, tailcut=True)
    params_dyn = MCMCParams(n_colors=n_col, proposal=ProposalKind.BALANCE_DYNAMIC,
                            tailcut=True)
    c = {
        "p": p_edge,
        "ratio": ratio,
        "n_colors": n_col,
        "max_degree": g.max_degree,
        "sequential_standard": cell(lambda: SequentialMCMCColorer(g, params_std),
                                    g, p_edge, seeds),
        "device_standard": cell(lambda: MCMCColorer(g, params_std, device=device),
                                g, p_edge, seeds),
        "device_balance_dynamic": cell(lambda: MCMCColorer(g, params_dyn, device=device),
                                       g, p_edge, seeds),
    }
    c["checks"] = cell_checks(c)
    c["variant_effect"] = variant_effect(g, n_col, min(seeds, 6), device=device)
    c["variants_separate"] = c["variant_effect"]["separates"]
    return c


def _stall_escape(args, device) -> int:
    with open(args.out) as f:
        matrix = json.load(f)
    rc = 0
    for c in matrix["cells"]:
        if c.get("sequential_stall_rate", 0) <= 0:
            continue
        g = erdos_renyi(matrix["n"], c["p"], seed=777)
        params = MCMCParams(n_colors=c["n_colors"], proposal=ProposalKind.STANDARD,
                            tailcut=True, seq_stall_escape=True)
        esc = cell(lambda: SequentialMCMCColorer(g, params), g, c["p"], matrix["seeds"])
        rate = round(1.0 - esc["valid"], 3) if esc["converged"] else 0.0
        c["sequential_stall_rate_escape_on"] = rate
        print(f"cell p={c['p']} ratio={c['ratio']}: stall "
              f"{c['sequential_stall_rate']} -> {rate} with escape on")
        rc |= rate > 0
    write_json(matrix, args.out, indent=1)
    print("patched →", args.out)
    return rc


def _patch(args, device) -> int:
    with open(args.out) as f:
        matrix = json.load(f)
    graphs = {}
    for c in matrix["cells"]:
        g = graphs.setdefault(c["p"], erdos_renyi(matrix["n"], c["p"], seed=777))
        c["checks"] = cell_checks(c)
        c.pop("variant_bi_gap", None)
        c["variant_effect"] = variant_effect(g, c["n_colors"], min(matrix["seeds"], 6),
                                             device=device)
        c["variants_separate"] = c["variant_effect"]["separates"]
        ve = c["variant_effect"]
        print(f"p={c['p']} ratio={c['ratio']}: checks={all(c['checks'].values())} "
              f"std(class_std)={ve['standard']['class_std_mean']:.2f} "
              f"dyn={ve['balance_dynamic']['class_std_mean']:.2f} "
              f"separates={ve['separates']}", flush=True)
    ok = all(all(c["checks"].values()) for c in matrix["cells"])
    matrix["any_variant_separation"] = any(c["variants_separate"] for c in matrix["cells"])
    ok = ok and matrix["any_variant_separation"]
    matrix["all_checks_pass"] = ok
    write_json(matrix, args.out, indent=1)
    print("patched →", args.out, "all_checks_pass:", ok)
    return 0 if ok else 1


def _plot(matrix, n, path) -> None:
    """The balance-index surface over the grid (the doVarCol3DGraph
    analogue), best-effort: skipped without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(projection="3d")
        palette = ("tab:blue", "tab:orange", "tab:green", "tab:red")
        for p_edge, color in zip(DENSITIES, palette):
            cells = [c for c in matrix["cells"] if c["p"] == p_edge]
            xs = [c["ratio"] for c in cells]
            zs = [c["device_balance_dynamic"]["balance_index"] for c in cells]
            ax.plot(xs, [p_edge] * len(xs), zs, marker="o", color=color, label=f"p={p_edge}")
        ax.set_xlabel("numColRatio")
        ax.set_ylabel("density p")
        ax.set_zlabel("balance index")
        ax.set_title(f"Balance index surface, ER(n={n}) (device chain, balance-dynamic)")
        ax.legend()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fig.savefig(path, dpi=120, bbox_inches="tight")
        print("plot →", path)
    except Exception as e:  # noqa: BLE001 (headless plot best-effort)
        print("plot skipped:", e)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--out", default=str(BUILD_DIR / "torch_validate_matrix.json"))
    ap.add_argument("--plot", default=str(BUILD_DIR / "torch_validate_matrix_3d.png"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default, the current card) or 'cpu' (the plain versions)")
    ap.add_argument(
        "--patch", action="store_true",
        help="recompute the checks and the variant-effect measurement on an existing "
        "report instead of re-running the full sequential/device matrix")
    ap.add_argument(
        "--stall-escape-cell", action="store_true",
        help="re-run the sequential chain of every cell that recorded a nonzero "
        "sequential_stall_rate with params.seq_stall_escape on (the reference's intended "
        "unlock_stall, coloringMCMC_CPUutils.cpp:49-67), and write "
        "sequential_stall_rate_escape_on into the report")
    args = ap.parse_args(argv)
    device = colorer_device(args.device)
    if args.stall_escape_cell:
        return _stall_escape(args, device)
    if args.patch:
        return _patch(args, device)

    matrix = {"n": args.n, "seeds": args.seeds, "cells": []}
    for p_edge in DENSITIES:
        g = erdos_renyi(args.n, p_edge, seed=777)
        for ratio in RATIOS:
            c = matrix_cell(g, p_edge, ratio, args.seeds, device)
            matrix["cells"].append(c)
            # every cell lands on disk as it completes (a partial file,
            # marked so), so a late failure loses nothing before it
            matrix["partial"] = True
            write_json(matrix, args.out + ".partial", indent=1)
            s, d = c["sequential_standard"], c["device_standard"]
            print(f"p={p_edge} ratio={ratio}: nCol={c['n_colors']} "
                  f"seqBI={s['balance_index']:.2f} devBI={d['balance_index']:.2f} "
                  f"dynBI={c['device_balance_dynamic']['balance_index']:.2f} "
                  f"conv(seq/dev)={s['converged']:.1f}/{d['converged']:.1f} "
                  f"checks={all(c['checks'].values())}", flush=True)

    ok = all(all(c["checks"].values()) for c in matrix["cells"])
    # the matrix must hold at least one regime where the balance machinery
    # separates measurably from the standard proposal, or it validates
    # nothing about the variants
    matrix["any_variant_separation"] = any(c["variants_separate"] for c in matrix["cells"])
    ok = ok and matrix["any_variant_separation"]
    matrix["all_checks_pass"] = ok
    matrix.pop("partial", None)
    write_json(matrix, args.out, indent=1)
    if os.path.exists(args.out + ".partial"):
        os.remove(args.out + ".partial")
    print("matrix →", args.out, "all_checks_pass:", ok)
    _plot(matrix, args.n, args.plot)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
