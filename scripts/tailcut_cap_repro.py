"""Replay one job of a benchmark cell on the card and report its NC
tailcut round by round.

A job of a cell whose traffic builds a graph a job is a pure function of
the run's ``--seed`` and the job's index: its graph seed is
``colorbench.seeds.graph_seed(seed, job)``, its chain seed
``chain_seed(seed)`` at repetition ``job``.  The script makes that job's
colourer through the cell's driver, as the benchmark's window does, runs
it once and prints one JSON line: the graph seed, the palette, the
conflicts the chain handed to the tailcut, the rounds and the conflicts
they left, whether the serial first-free pass ran (null where the
program has none) and the job's final conflicts; and, for each round,
the conflicted vertices with their coins, whether each was a head and
whether it moved.  It reads the program's ``_tailcut_nc_round`` and
``_finish_first_free`` through wrappers and changes nothing they do.

    python scripts/tailcut_cap_repro.py --seed 2718281829 --job 814

runs the job of ``er100k_p01.fresh`` that ended unfinished at JAX's cap
of 16 + 2 * conflicts rounds (graph seed 3982634946).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="er100k_p01.fresh")
    ap.add_argument("--seed", type=int, required=True, help="the run's --seed")
    ap.add_argument("--job", type=int, required=True, help="the job's index in the window")
    args = ap.parse_args(argv)

    import torch

    from colorbench import seeds, spec
    from colorbench.loop import load_kernels, make_graph
    from mcmc_colorer_tpu_torch.models import mcmc_resident as mr
    from mcmc_colorer_tpu_torch.models.mcmc import _at_color
    from mcmc_colorer_tpu_torch.ops.dense_adj import neighbor_color_counts

    device = torch.device("cuda", 0)
    cell = spec.cell(args.cell)
    if cell.traffic["graph"] != "per_job":
        raise SystemExit(f"{args.cell}: its traffic reuses one graph; give a cell whose jobs "
                         "build their own")
    kinds = [(j, spec.driver(cell.config["path"], j["colorer"])) for j in cell.traffic["jobs"]]
    job, driver = kinds[args.job % len(kinds)]
    load_kernels(driver.KERNELS)
    gseed = seeds.graph_seed(args.seed, args.job)
    colorer = driver.make(cell.config, job, make_graph(cell.config, gseed), device)

    rounds, seen = [], {}
    entry = {}
    tailcut, round_fn = mr._tailcut_nc, mr._tailcut_nc_round
    finish = getattr(mr, "_finish_first_free", None)

    def tailcut_spy(adj, colors, conflicts, sources, node_mask, **kw):
        entry["conflicts"] = [int(c) for c in conflicts]
        return tailcut(adj, colors, conflicts, sources, node_mask, **kw)

    def round_spy(adj, colors, coin_unif, node_mask, nc_prev=None, running=None, *, n_colors):
        nc = neighbor_color_counts(adj, colors, n_colors, node_mask)
        bad = torch.nonzero((_at_color(nc[0], colors[0]) > 0) & node_mask).flatten()
        del nc
        out, conflicts, nc_new = round_fn(adj, colors, coin_unif, node_mask, nc_prev, running,
                                          n_colors=n_colors)
        rounds.append({
            "conflicts_after": int(conflicts[0]),
            "vertices": [{"v": int(v), "color": int(colors[0, v]),
                          "coin": float(coin_unif[0, v]), "head": bool(coin_unif[0, v] < 0.5),
                          "moved_to": int(out[0, v]) if out[0, v] != colors[0, v] else None}
                         for v in bad.tolist()],
        })
        return out, conflicts, nc_new

    def finish_spy(adj, colors, conflicts, node_mask, **kw):
        seen["finish_entry"] = [int(c) for c in conflicts]
        out, conf = finish(adj, colors, conflicts, node_mask, **kw)
        seen["moved"] = [{"v": int(v), "from": int(colors[0, v]), "to": int(out[0, v])}
                         for v in torch.nonzero(out[0] != colors[0]).flatten().tolist()]
        return out, conf

    mr._tailcut_nc, mr._tailcut_nc_round = tailcut_spy, round_spy
    if finish is not None:
        mr._finish_first_free = finish_spy
    try:
        res = driver.run(colorer, seeds.chain_seed(args.seed), args.job)
    finally:
        mr._tailcut_nc, mr._tailcut_nc_round = tailcut, round_fn
        if finish is not None:
            mr._finish_first_free = finish
    after_rounds = rounds[-1]["conflicts_after"] if rounds else None
    print(json.dumps({
        "cell": args.cell, "seed": args.seed, "job": args.job, "graph_seed": gseed,
        "n_colors": int(res["n_colors"]), "sweeps": int(res["sweeps"]),
        "tailcut_entry_conflicts": entry.get("conflicts"), "tailcut_rounds": len(rounds),
        "conflicts_after_rounds": after_rounds,
        "first_free_pass": (None if finish is None
                            else {"ran": "finish_entry" in seen, **seen}),
        "final_conflicts": int(res["conflicts"]),
        "rounds": rounds,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
