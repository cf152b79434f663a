"""Run the five BASELINE.md benchmark configs and write a JSON report.

1. ER n=1000 p=0.1: the sequential MCMC chain (reference semantics)
2. Luby colorer on ER n=100k p=0.01
3. MCMC balanced colouring on ER(1M, 0.001), a numColRatio sweep with
   the balance index
4. a heavy-tailed (Barabási–Albert) graph through the converters: the
   network-repository layout, and (4b) the reddit CSV layout
5. a 64-chain ensemble with best-of-chains selection

Usage:

    python -m mcmc_colorer_tpu_torch.scripts.run_baseline_configs \
        [--out build/torch_baseline_report.json] [--small] [--device cuda]

``--small`` shrinks everything for a fast smoke run; ``--device cpu``
runs the colorers' plain versions on the CPU (without it, and without a
card, the script raises).  Each config is a function,
``config1(small, device)`` ... ``config5(small, device)``, returning its
report entries.

The report's keys are those of the JAX package's script, except:

- ``"device"`` (the card's name and power limit from ``nvidia-smi``, or
  ``"cpu"``) and ``"torch"`` (its version) stand where JAX's report has
  ``"backend"`` and ``"compile_cache"`` (XLA's, which the port has no
  use for);
- config 2 is timed like configs 3 and 4 (``timed_split``: two runs,
  the first bearing the one-time costs), since a Luby run on the card
  takes seconds; its entry keeps the keys JAX's ``timed_segments`` shares
  with that (``seconds_setup``, ``seconds_total``, ``seconds_steady``),
  has ``seconds_compile`` in place of ``seconds_compile_est``, and no
  ``segments`` (the port's Luby loop is not segmented);
- config 3 runs at its configured size or fails: JAX's retry at half the
  vertices after an out-of-memory error is left out, so no smaller graph
  is reported under config 3's name.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.graph import io as gio
from mcmc_colorer_tpu_torch.graph.generate import barabasi_albert, erdos_renyi
from mcmc_colorer_tpu_torch.models.base import check_coloring, colorer_device
from mcmc_colorer_tpu_torch.scripts import BUILD_DIR, device_report, write_json

# the configurations (full size; --small in brackets where it differs)
CONFIG1_N, CONFIG1_P, CONFIG1_SEED, CONFIG1_RUN_SEED = 1000, 0.1, 1, 11          # [200]
CONFIG2_N, CONFIG2_P, CONFIG2_SEED, CONFIG2_RUN_SEED = 100_000, 0.01, 2, 21      # [2000, 0.02]
CONFIG3_N, CONFIG3_P, CONFIG3_SEED, CONFIG3_RATIOS = 1_000_000, 0.001, 3, (1.0, 2.0, 4.0)
CONFIG3_RUN_SEED = 31                                                            # [5000, 0.01]
CONFIG4_N, CONFIG4_M, CONFIG4_SEED, CONFIG4_RUN_SEED = 50_000, 8, 4, 41          # [1000]
CONFIG4B_N, CONFIG4B_M, CONFIG4B_SEED, CONFIG4B_RUN_SEED = 5_000, 6, 44, 42      # [500]
CONFIG5_N, CONFIG5_P, CONFIG5_SEED, CONFIG5_RUN_SEED = 20_000, 0.002, 5, 51      # [500, 0.05]
CONFIG5_CHAINS = 64                                                              # [8]


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def timed_split(colorer, seed):
    """Run twice on the same colorer: the first run bears the one-time
    costs (the kernels' build or load, torch's CUDA module loading), the
    second is the steady per-run cost."""
    r, t_total = timed(lambda: colorer.run(seed=seed))
    _, t_steady = timed(lambda: colorer.run(seed=seed))
    return r, {
        "seconds_total": round(t_total, 2),
        "seconds_compile": round(max(0.0, t_total - t_steady), 2),
        "seconds_steady": round(t_steady, 2),
    }


def config1(small: bool, device) -> dict:
    """Sequential MCMC on ER(1000, 0.1) (host numpy; ``device`` unused)."""
    from mcmc_colorer_tpu_torch.models.mcmc_sequential import SequentialMCMCColorer

    g1 = erdos_renyi(CONFIG1_N if not small else 200, CONFIG1_P, seed=CONFIG1_SEED)
    p1 = MCMCParams(n_colors=g1.max_degree, proposal=ProposalKind.STANDARD)
    r1, t1 = timed(lambda: SequentialMCMCColorer(g1, p1).run(seed=CONFIG1_RUN_SEED))
    entry = {
        "n": g1.n,
        "valid": check_coloring(g1, r1.colors),
        "iterations": r1.iterations,
        "used_colors": r1.used_colors,
        "balance_index": r1.balance_index(CONFIG1_P),
        "seconds": t1,
    }
    print("config1:", entry, flush=True)
    return {"config1_sequential": entry}


def config2(small: bool, device) -> dict:
    """Luby on ER(100k, 0.01)."""
    from mcmc_colorer_tpu_torch.models.luby import LubyColorer

    n2 = CONFIG2_N if not small else 2000
    g2 = erdos_renyi(n2, CONFIG2_P if not small else 0.02, seed=CONFIG2_SEED)
    colorer2, t2_setup = timed(lambda: LubyColorer(g2, device=device))
    r2, t2 = timed_split(colorer2, CONFIG2_RUN_SEED)
    entry = {
        "n": g2.n,
        "m": g2.n_edges,
        "valid": check_coloring(g2, r2.colors),
        "colors": r2.n_colors,
        "seconds_setup": round(t2_setup, 2),
        **t2,
    }
    print("config2:", entry, flush=True)
    return {"config2_luby": entry}


def config3(small: bool, device) -> dict:
    """MCMC numColRatio sweep on ER(1M, 0.001)."""
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer

    n3 = CONFIG3_N if not small else 5000
    p_edge3 = CONFIG3_P if not small else 0.01
    g3 = erdos_renyi(n3, p_edge3, seed=CONFIG3_SEED)
    print(f"config3 graph: n={g3.n} m={g3.n_edges} maxdeg={g3.max_degree}", flush=True)
    sweep = {}
    for ratio in CONFIG3_RATIOS:
        # reference semantics: the flag divides the palette (main.cu:53
        # inverts, :162 multiplies by the inverse)
        n_col = max(4, int(g3.max_degree / ratio))
        p3 = MCMCParams(n_colors=n_col, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
        colorer3, t3_setup = timed(lambda: MCMCColorer(g3, p3, device=device))
        r3, t3 = timed_split(colorer3, CONFIG3_RUN_SEED)
        sweep[str(ratio)] = {
            "n_colors": n_col,
            "valid": check_coloring(g3, r3.colors),
            "iterations": r3.iterations,
            "used_colors": r3.used_colors,
            "balance_index": r3.balance_index(p_edge3),
            "seconds_setup": round(t3_setup, 2),
            **t3,
        }
        del colorer3
        print(f"config3 ratio={ratio}:", sweep[str(ratio)], flush=True)
    return {"config3_ratio_sweep": {"n": n3, "p": p_edge3, "sweep": sweep}}


def _edge_pairs(g):
    """(u, v) with u < v: each undirected edge once."""
    u = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees)
    v = g.cols.astype(np.int64)
    mask = u < v
    return u[mask], v[mask]


def config4(small: bool, device) -> dict:
    """The real-world pipeline through the converters.  The reference
    colours network-repository and reddit datasets after converting them
    (pyScripts/convertDataset.py:1-65, convertReddit.py); with no data
    set at hand, a BA sample (the same heavy-tailed regime) is written in
    each upstream layout and driven through converter, importer and
    colorer: (4) the network-repository layout, (4b) the reddit CSV."""
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer

    report = {}
    g0 = barabasi_albert(CONFIG4_N if not small else 1000, CONFIG4_M, seed=CONFIG4_SEED)
    with tempfile.TemporaryDirectory() as td:
        # the .mtx-like layout: comment header, counts line, bare src/dst
        # pairs, and two self-arcs as real dumps have
        raw = f"{td}/soc-sample.mtx"
        with open(raw, "w") as f:
            f.write("%% networkrepository sample (BA 50k regime)\n")
            f.write(f"{g0.n} {g0.n} {g0.n_edges}\n")
            f.writelines(f"{a} {b}\n" for a, b in zip(*_edge_pairs(g0)))
            f.write("7 7\n17 17\n")  # self-arcs: testSelfArcs.py regime
        conv = f"{td}/soc-sample.txt"
        gio.convert_network_repository(raw, conv)
        clean = f"{td}/soc-sample-clean.txt"
        n_self = gio.strip_self_arcs(conv, clean)
        g4 = gio.load_edge_list(clean)
    p4 = MCMCParams(n_colors=g4.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    colorer4, t4_setup = timed(lambda: MCMCColorer(g4, p4, device=device))
    r4, t4 = timed_split(colorer4, CONFIG4_RUN_SEED)
    report["config4_real_world_converted"] = {
        "converter": "convert_network_repository + strip_self_arcs",
        "self_arcs_removed": n_self,
        "n": g4.n,
        "m": g4.n_edges,
        "max_deg": g4.max_degree,
        "valid": check_coloring(g4, r4.colors),
        "used_colors": r4.used_colors,
        "seconds_setup": round(t4_setup, 2),
        **t4,
    }
    print("config4:", report["config4_real_world_converted"], flush=True)
    del colorer4

    g0b = barabasi_albert(CONFIG4B_N if not small else 500, CONFIG4B_M, seed=CONFIG4B_SEED)
    with tempfile.TemporaryDirectory() as td:
        raw = f"{td}/reddit.csv"
        with open(raw, "w") as f:
            f.writelines(f"r/{a},r/{b},2019\n" for a, b in zip(*_edge_pairs(g0b)))
        conv = f"{td}/reddit.txt"
        gio.convert_reddit_csv(raw, conv)
        # converted files carry no header line; load_edge_list skips line
        # 1 (fileImporter.cpp:27), so the header is prepended, as the
        # reference's convention is
        with open(conv) as f:
            body = f.read()
        with open(conv, "w") as f:
            f.write(f"{g0b.n} {g0b.n_edges}\n" + body)
        g4b = gio.load_edge_list(conv)
    p4b = MCMCParams(n_colors=g4b.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC,
                     tailcut=True)
    colorer4b, t4b_setup = timed(lambda: MCMCColorer(g4b, p4b, device=device))
    r4b, t4b = timed_split(colorer4b, CONFIG4B_RUN_SEED)
    report["config4b_reddit_converted"] = {
        "converter": "convert_reddit_csv",
        "n": g4b.n,
        "m": g4b.n_edges,
        "valid": check_coloring(g4b, r4b.colors),
        "used_colors": r4b.used_colors,
        "seconds_setup": round(t4b_setup, 2),
        **t4b,
    }
    print("config4b:", report["config4b_reddit_converted"], flush=True)
    return report


def config5(small: bool, device) -> dict:
    """A 64-chain ensemble with best-of-chains selection."""
    from mcmc_colorer_tpu_torch.parallel.chains import EnsembleMCMCColorer

    g5 = erdos_renyi(CONFIG5_N if not small else 500, CONFIG5_P if not small else 0.05,
                     seed=CONFIG5_SEED)
    p5 = MCMCParams(n_colors=g5.max_degree, proposal=ProposalKind.BALANCE_DYNAMIC)
    ens = EnsembleMCMCColorer(g5, p5, n_chains=CONFIG5_CHAINS if not small else 8,
                              device=device)
    best, summaries = ens.run(seed=CONFIG5_RUN_SEED)
    entry = {
        "n": g5.n,
        "chains": len(summaries),
        "best_chain": best.extra["best_chain"],
        "best_conflicts": best.extra["final_conflicts"],
        "valid": check_coloring(g5, best.colors),
        "conflict_spread": [s["conflicts"] for s in summaries[:10]],
        "seconds": best.duration_ms / 1e3,
    }
    print("config5:", entry, flush=True)
    return {"config5_ensemble": entry}


CONFIGS = (config1, config2, config3, config4, config5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(BUILD_DIR / "torch_baseline_report.json"))
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default, the current card) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    device = colorer_device(args.device)
    report = {"device": device_report(device), "torch": torch.__version__}
    for config in CONFIGS:
        report.update(config(args.small, device))
        if device.type == "cuda":
            torch.cuda.empty_cache()  # free one config's device arrays before the next
    write_json(report, args.out, indent=1, default=str)
    print("report →", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
