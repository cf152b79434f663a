"""Offline analysis: run-log parsing and quality metrics (the port's own
copy of ``mcmc_colorer_tpu/analysis/log_parser.py``, so logs written on a
machine without jax are analysed there).

Counterpart of the reference's pyScripts pipeline (SURVEY §2.4):
``logParser.py`` (log → JSON), ``doBalIdxgraph.py`` (balance index),
``doSpeedupGraph.py`` (speedups), ``doVarCol3DGraph.py`` (the balance
index over numColRatio and density), ``checkNoConv*.py``
(non-convergence counts).  Parses the shared field-name contract
("Nodes:", "Execution time:", "Iteration performed:", ... — reference
coloringMCMC_CPUutils.cpp:70-102) so the reference's logs, the JAX
package's and this package's (``utils/logging.py``) feed the same
analysis.  Host code over text files: numpy, no torch.

One default differs from the JAX module: ``var_col_surface`` and
``plot_var_col_3d`` read the ``MCMC_GPU`` runs, the tag this package's
CLI gives its device chain; JAX's read ``MCMC_TPU``.  With ``algo``
given the two modules return the same.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict

import numpy as np

_HIST_LINE = re.compile(r"^(\d+):\s*(\d+)\s*$")


def parse_log_file(path: str) -> dict:
    """Parse one ``<name>-<ALGO>-<rep>.log`` into a flat dict."""
    out: dict = {"path": path}
    hist: dict[int, int] = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            m = _HIST_LINE.match(line)
            if m:
                hist[int(m.group(1))] = int(m.group(2))
                continue
            if line.startswith("Nodes:"):
                parts = line.replace("-", " ").split()
                out["nodes"] = int(parts[1])
                if "Edges:" in line:
                    out["edges"] = int(parts[parts.index("Edges:") + 1])
            elif line.startswith("Max deg:"):
                nums = re.findall(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?", line)
                if len(nums) >= 3:
                    out["max_deg"], out["min_deg"], out["avg_deg"] = (
                        float(nums[0]),
                        float(nums[1]),
                        float(nums[2]),
                    )
            elif line.startswith("Edge probability"):
                out["prob"] = float(line.split(":")[-1])
            elif line.startswith("Seed:"):
                out["seed"] = int(float(line.split(":")[-1]))
            elif line.startswith("Repetition:"):
                out["repetition"] = int(line.split(":")[-1])
            elif line.startswith("Execution time:"):
                out["execution_time_s"] = float(line.split(":")[-1])
            elif line.startswith("Iteration performed:"):
                out["iterations"] = int(line.split(":")[-1])
            elif line.startswith("Max iteration reached:"):
                out["max_iteration_reached"] = "yes" in line
            elif line.startswith("Number of colors:"):
                nums = re.findall(r"\d+", line)
                out["n_colors"] = int(nums[0])
                if len(nums) > 1:
                    out["used_colors"] = int(nums[1])
            elif line.startswith("Color ratio:"):
                out["color_ratio"] = float(line.split(":")[-1])
            elif line.startswith("Average number of nodes for each color:"):
                out["class_mean"] = float(line.split(":")[-1])
            elif line.startswith("Variance:"):
                out["class_variance"] = float(line.split(":")[-1])
            elif line.startswith("StD:"):
                out["class_std"] = float(line.split(":")[-1])
            elif line.startswith("BalancingIndex"):
                out["balancing_index"] = float(line.split()[-1])
    if hist:
        out["histogram"] = [hist.get(i, 0) for i in range(max(hist) + 1)]
    return out


def parse_gpu_results_file(path: str) -> dict:
    """Parse the reference's OLD GPU-run dialect (``resultsFile-*`` files).

    The writer no longer exists in the reference tree; the format is
    defined by its parser, pyScripts/logParser.py:56-84
    (mcmcGpuLineParser): ``time <s>``, one ``iteration_*`` line per chain
    iteration (the count IS the iteration number), ``numCol``/
    ``numColorRatio``, and ``end_used_colors``/``end_average``/
    ``end_variance``/``end_standard_deviation`` finals, with the color
    histogram between ``max_iteration_reached`` and ``end_used_colors``
    as ``<label> <count>`` lines.  Output uses this module's unified
    schema (same keys as `parse_log_file`)."""
    out: dict = {"path": path, "dialect": "gpu"}
    hist: list[int] = []
    iter_count = 0
    in_hist = False
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            items = line.split(" ")
            if "end_used_colors" in line:
                in_hist = False
                out["used_colors"] = int(items[1])
            elif in_hist:
                if len(items) > 1 and items[1].lstrip("-").isdigit():
                    hist.append(int(items[1]))
                continue
            elif "max_iteration_reached" in line:
                out["max_iteration_reached"] = "no" not in line
                in_hist = True
            elif line.startswith("time "):
                out["execution_time_s"] = float(items[1])
            elif "iteration_" in line:
                iter_count += 1
            elif line.startswith("numColorRatio"):
                out["color_ratio"] = float(items[1])
            elif line.startswith("numCol "):
                out["n_colors"] = int(items[1])
            elif line.startswith("end_average"):
                out["class_mean"] = float(items[1])
            elif line.startswith("end_variance"):
                out["class_variance"] = float(items[1])
            elif line.startswith("end_standard_deviation"):
                out["class_std"] = float(items[1])
    out["iterations"] = iter_count
    if hist:
        out["histogram"] = hist
    return out


_LOG_NAME = re.compile(r"^(?P<name>.+)-(?P<algo>[A-Za-z_]+)-(?P<rep>\d+)\.log$")
_GPU_RESULTS_NAME = re.compile(
    r"^resultsFile-(?P<name>.+)-(?P<rep>\d+)\.(log|txt)$"
)


def parse_results_dir(root: str) -> dict:
    """Walk a results tree, parse every run log, and group by algorithm —
    the role of logParser.py's directory walkers (logParser.py:243-265).
    Returns {algo: [run dict, ...]}."""
    results: dict[str, list] = defaultdict(list)
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            gm = _GPU_RESULTS_NAME.match(fn)
            if gm:  # reference GPU-run dialect (logParser.py:224-231)
                rec = parse_gpu_results_file(os.path.join(dirpath, fn))
                rec["graph_name"] = gm.group("name")
                rec["repetition"] = int(gm.group("rep"))
                results["MCMC_GPU"].append(rec)
                continue
            m = _LOG_NAME.match(fn)
            if not m:
                continue
            rec = parse_log_file(os.path.join(dirpath, fn))
            rec["graph_name"] = m.group("name")
            rec["repetition"] = int(m.group("rep"))
            results[m.group("algo")].append(rec)
    return dict(results)


def save_results_json(root: str, out_path: str) -> dict:
    """logParser.py's final merged-JSON output (finalRes.json role)."""
    res = parse_results_dir(root)
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    return res


# ------------------------------ metrics ------------------------------------


def balance_index(
    histogram, n_nodes: int, prob: float, n_colors: int | None = None
) -> float:
    """BI = sqrt(Σ_{used}(count − n/nCol)² / (n·p)) — identical to
    coloringMCMC_prints.cu:148-168 (average over the FULL palette nCol,
    sum over used colors only).

    ``n_colors`` is the palette size; pass the log's "Number of colors"
    so trailing unused colors don't shrink the average (a reconstructed
    histogram only reaches the largest used index — VERDICT r1)."""
    h = np.asarray(histogram, dtype=np.float64)
    avg = n_nodes / (n_colors if n_colors else len(h))
    used = h > 0
    return float(np.sqrt(((h[used] - avg) ** 2).sum() / (n_nodes * prob)))


def count_non_convergent(runs: list[dict]) -> int:
    """checkNoConv*.py: count runs that hit the iteration cap."""
    return sum(1 for r in runs if r.get("max_iteration_reached"))


_SPEEDUP_PAIRS = [
    ("MCMC_CPU", "MCMC_TPU"),
    ("LUBY", "MCMC_TPU"),
    ("MCMC_CPU", "MCMC_GPU"),
    ("LUBY", "MCMC_GPU"),
]


def _mean_by_size(results: dict, field: str, default: float) -> dict:
    out: dict[str, dict] = {}
    for algo, runs in results.items():
        per_graph = defaultdict(list)
        for r in runs:
            per_graph[r.get("nodes")].append(r.get(field, default))
        out[algo] = {k: float(np.mean(v)) for k, v in per_graph.items()}
    return out


def _pair_ratios(mean_a: dict, mean_b: dict | None = None) -> dict:
    mean_b = mean_a if mean_b is None else mean_b
    out = {}
    for a, b in _SPEEDUP_PAIRS:
        if a in mean_a and b in mean_a:
            common = set(mean_a[a]) & set(mean_a[b])
            out[f"{a}/{b}"] = {
                n: mean_a[a][n] / mean_a[b][n]
                for n in sorted(common, key=lambda x: (x is None, x))
                if mean_a[b][n] > 0
            }
    return out


def speedups(results: dict) -> dict:
    """Mean execution-time ratios between algorithms, per graph size — the
    measurements of doSpeedupGraph.py:62-92 (T_seq/T_parallel etc.)."""
    return _pair_ratios(_mean_by_size(results, "execution_time_s", 0.0))


def per_iteration_speedups(results: dict) -> dict:
    """Per-iteration speedup: ratios of (mean time / mean iterations) —
    the "Speed-up (per iteration)" plot of doSpeedupGraph.py:76-92."""
    mean_t = _mean_by_size(results, "execution_time_s", 0.0)
    mean_i = _mean_by_size(results, "iterations", 1.0)
    per_iter = {
        algo: {
            n: t / max(mean_i.get(algo, {}).get(n, 1.0), 1e-12)
            for n, t in sizes.items()
        }
        for algo, sizes in mean_t.items()
    }
    return _pair_ratios(per_iter)


def var_col_surface(results: dict, algo: str = "MCMC_GPU") -> dict:
    """Balance index over the (numColRatio, density) grid — the data
    behind doVarCol3DGraph.py's surface plot (doVarCol3DGraph.py:40-50,
    k = n·p·colorRatio).  Returns {(ratio, prob): mean balance index}."""
    grid: dict = defaultdict(list)
    for r in results.get(algo, []):
        if not r.get("histogram") or "prob" not in r:
            continue
        ratio = r.get("color_ratio", 1.0)
        bi = balance_index(
            r["histogram"], r["nodes"], r["prob"], r.get("n_colors")
        )
        grid[(ratio, r["prob"])].append(bi)
    return {k: float(np.mean(v)) for k, v in grid.items()}


def plot_speedup(
    results: dict, out_path: str, per_iteration: bool = False
) -> bool:
    """doSpeedupGraph.py-style speedup plot; ``per_iteration=True``
    renders its second figure (time/iteration ratios,
    doSpeedupGraph.py:76-92)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    sp = per_iteration_speedups(results) if per_iteration else speedups(
        results
    )
    fig, ax = plt.subplots(figsize=(8, 5))
    plotted = False
    for pair, series in sp.items():
        if not series:
            continue
        xs = sorted(k for k in series if k is not None)
        ax.plot(xs, [series[x] for x in xs], marker="o", label=pair)
        plotted = True
    ax.set_xlabel("nodes")
    ax.set_ylabel("speedup (time ratio)")
    ax.set_title(
        "Algorithm speedups"
        + (" (per iteration)" if per_iteration else "")
    )
    if plotted:
        ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def plot_var_col_3d(
    results: dict, out_path: str, algo: str = "MCMC_GPU"
) -> bool:
    """3D surface of balance index vs (numColRatio, density)
    (doVarCol3DGraph{,_new}.py)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    grid = var_col_surface(results, algo)
    if not grid:
        return False
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    ratios = [k[0] for k in grid]
    probs = [k[1] for k in grid]
    bis = [grid[k] for k in grid]
    try:
        if len(grid) >= 3:
            ax.plot_trisurf(ratios, probs, bis, cmap="viridis")
        else:
            ax.scatter(ratios, probs, bis)
    except RuntimeError:  # collinear/degenerate grid → point cloud
        ax.scatter(ratios, probs, bis)
    ax.set_xlabel("numColRatio")
    ax.set_ylabel("density p")
    ax.set_zlabel("balance index")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def plot_balance_index(results: dict, out_path: str, prob: float) -> bool:
    """doBalIdxgraph.py-style plot; returns False when matplotlib is
    unavailable (zero-egress images may lack it)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    fig, ax = plt.subplots(figsize=(8, 5))
    for algo, runs in sorted(results.items()):
        pts = [
            (
                r["nodes"],
                balance_index(
                    r["histogram"], r["nodes"], prob, r.get("n_colors")
                ),
            )
            for r in runs
            if r.get("histogram") and abs(r.get("prob", prob) - prob) < 1e-12
        ]
        if not pts:
            continue
        pts.sort()
        ax.plot(*zip(*pts), marker="o", label=algo)
    ax.set_xlabel("nodes")
    ax.set_ylabel("balance index")
    ax.set_title(f"Balance index vs graph size (p={prob})")
    ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True
