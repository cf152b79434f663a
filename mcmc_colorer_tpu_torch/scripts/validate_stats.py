"""Statistical equivalence of the device chain with the sequential one:
BASELINE config 1.

ER(n=1000, p=0.1), 20 seeds: the sequential reference-semantics chain
against the device chain (``MCMCColorer``, K2), compared on outcome
metrics (used colours, iterations to converge, balance index, class-size
std), BASELINE.md's criterion ("within Monte-Carlo error").

Usage:

    python -m mcmc_colorer_tpu_torch.scripts.validate_stats \
        [--seeds N] [--n N] [--p P] [--out build/torch_validate_stats.json] [--device cuda]

Exits 0 when all four checks hold, else 1.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.graph.generate import erdos_renyi
from mcmc_colorer_tpu_torch.models.base import check_coloring, colorer_device
from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
from mcmc_colorer_tpu_torch.models.mcmc_sequential import SequentialMCMCColorer
from mcmc_colorer_tpu_torch.scripts import BUILD_DIR, write_json


def summarize(rows):
    arr = {k: np.array([r[k] for r in rows], dtype=float) for k in rows[0]}
    return {k: {"mean": float(v.mean()), "std": float(v.std())} for k, v in arr.items()}


def validate(n: int = 1000, p: float = 0.1, seeds: int = 20, device="cuda") -> dict:
    """The report: the configuration, both chains' summaries over
    ``seeds`` runs (seeds 1000, 1001, ...) and the four checks."""
    device = colorer_device(device)
    g = erdos_renyi(n, p, seed=777)
    params = MCMCParams(n_colors=g.max_degree, proposal=ProposalKind.STANDARD)
    print(f"graph n={g.n} m={g.n_edges} maxdeg={g.max_degree} nCol={params.n_colors}",
          flush=True)

    def run(factory, label):
        rows = []
        for s in range(seeds):
            r = factory().run(seed=1000 + s)
            rows.append({
                "used_colors": r.used_colors,
                "iterations": r.iterations,
                "balance_index": r.balance_index(p),
                "class_std": r.class_stats()["std"],
                "converged": float(r.converged),
                "valid": float(check_coloring(g, r.colors)),
            })
            print(f"{label} seed {s}: {rows[-1]}", flush=True)
        return rows

    seq = run(lambda: SequentialMCMCColorer(g, params), "seq")
    par = run(lambda: MCMCColorer(g, params, device=device), "device")
    report = {
        "config": {"n": n, "p": p, "n_colors": params.n_colors, "seeds": seeds},
        "sequential": summarize(seq),
        "parallel": summarize(par),
    }
    s, p_ = report["sequential"], report["parallel"]
    report["checks"] = {
        "all_valid": all(r["valid"] for r in seq + par),
        "all_converged_within_budget": all(r["converged"] for r in seq + par),
        "used_colors_within_15pct": abs(s["used_colors"]["mean"] - p_["used_colors"]["mean"])
        <= 0.15 * max(s["used_colors"]["mean"], p_["used_colors"]["mean"]),
        "balance_index_within_2std": abs(
            s["balance_index"]["mean"] - p_["balance_index"]["mean"])
        <= 2 * (s["balance_index"]["std"] + p_["balance_index"]["std"]) + 0.5,
    }
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--p", type=float, default=0.1)
    ap.add_argument("--out", default=str(BUILD_DIR / "torch_validate_stats.json"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default, the current card) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    report = validate(args.n, args.p, args.seeds, args.device)
    write_json(report, args.out, indent=1)
    print(json.dumps(report["checks"], indent=1))
    return 0 if all(report["checks"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
