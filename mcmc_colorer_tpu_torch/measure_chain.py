"""One chain on the card: its milliseconds a sweep and its host reads.

    python3 -m mcmc_colorer_tpu_torch.measure_chain [--runs N] [--out PATH]

Needs one CUDA device.  At ER(100k, 0.01) (the resident bench's hash
graph, graph seed 0; the host graph re-derived from it), seed 5, it runs
``MCMCColorer(backend="pallas")`` (the K2 do-while and the K3 tailcut)
at numColRatio 1 and 4 (the second runs ~30 sweeps, so that a run's
fixed costs weigh less) and ``ResidentMCMCColorer`` (the K1 do-while and
the NC tailcut) at numColRatio 1: each once to warm up, ``--runs`` times
timed (the chain's seconds over its sweeps, from the run's ``extra``;
the median and the range), and once under torch's CUDA sync debug mode, which counts every
operation that waited for the card, beside the run's sweeps and tailcut
rounds.  The result goes to ``--out`` as JSON, with the card's name and
power limit.

The module imports only the package it lies in and uses only the
colourers' public surface, so that an earlier commit's package can run
it: copy it into a checkout of that commit (``git archive <commit>
mcmc_colorer_tpu_torch native | tar -x -C build/parent``) and run it from
there; run parent, change, change, parent in one call to compare on one
card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import warnings
from pathlib import Path

import numpy as np
import torch

GRAPH = (100_000, 0.01, 0)   # n, p, graph seed: the resident bench
SEED = 5


def _syncs(fn) -> int:
    """Operations that waited for the card while ``fn`` ran."""
    count = 0

    def record(message, *_a, **_k):
        nonlocal count
        count += "synchroniz" in str(message)

    with warnings.catch_warnings():
        # the mode's first use warns once that it is a prototype: no sync
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return count


def _chain(label: str, colorer, runs: int) -> dict:
    colorer.run(SEED)  # warm-up
    ms, sweeps = [], 0
    for _ in range(runs):
        r = colorer.run(SEED)
        sweeps = int(r.extra["sweeps"])
        ms.append(r.extra["chain_seconds"] * 1e3 / max(sweeps, 1))
    out = {}
    syncs = _syncs(lambda: out.setdefault("r", colorer.run(SEED)))
    r = out["r"]
    row = {"sweeps": sweeps, "iterations": int(r.iterations),
           "tailcut_rounds": int(r.extra["tailcut_rounds"]),
           "final_conflicts": int(r.extra["final_conflicts"]),
           "ms_a_sweep": float(np.median(ms)), "ms_a_sweep_range": [min(ms), max(ms)],
           "host_syncs": syncs}
    print(f"{label}: {json.dumps(row)}", flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/measure_chain.json")
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("measure_chain: no CUDA device")
    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind, default_n_colors
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
    from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    package = str(Path(__file__).resolve().parent)
    print(f"card: {smi}; torch {torch.__version__}; package {package}", flush=True)
    resident = ResidentMCMCColorer(*GRAPH, device=device)
    g = resident.host_graph()
    params = MCMCParams(n_colors=resident.params.n_colors,
                        proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True)
    tight = params.replace(n_colors=default_n_colors(resident.max_degree, 4.0))
    result = {"card": smi, "package": package, "graph": list(GRAPH), "seed": SEED,
              "n_colors": [params.n_colors, tight.n_colors]}
    for label, colorer in (("MCMCColorer pallas", MCMCColorer(g, params, device=device)),
                           ("MCMCColorer pallas ratio 4", MCMCColorer(g, tight, device=device)),
                           ("ResidentMCMCColorer", resident)):
        result[label] = _chain(label, colorer, args.runs)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
