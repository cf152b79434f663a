"""Per-run statistics files (a copy of ``mcmc_colorer_tpu/utils/logging.py``
with the header naming the GPU framework).

Keeps the reference's log field names verbatim so the offline analysis
pipeline (pyScripts/logParser.py, this package's
:mod:`mcmc_colorer_tpu_torch.analysis.log_parser` and the JAX package's
``mcmc_colorer_tpu.analysis.log_parser``) parses both implementations'
logs interchangeably (SURVEY §6 observability: "Nodes:", "Execution time:",
"Iteration performed:", "Max iteration reached:", "Color histogram:",
"Number of colors:", "Used colors:", "Average number of nodes for each
color:", "Variance:", "StD:" — reference coloringMCMC_CPUutils.cpp:70-102 —
plus the GPU log's BalancingIndex, coloringMCMC_prints.cu:195,224).
"""

from __future__ import annotations

import os

import numpy as np

from mcmc_colorer_tpu_torch.graph.container import Graph
from mcmc_colorer_tpu_torch.models.base import Coloring


def format_run_stats(
    g: Graph,
    coloring: Coloring,
    *,
    algo: str,
    repetition: int,
    seed: int,
    prob: float | None = None,
    num_color_ratio: float = 1.0,
) -> str:
    """Render the per-run report (layout of saveStats,
    coloringMCMC_CPUutils.cpp:70-102)."""
    hist = coloring.histogram
    stats = coloring.class_stats()
    lines = [
        f"MCMC Colorer - GPU framework - {algo} - Report",
        "-------------------------------------------",
        "GRAPH INFO",
        f"Nodes: {g.n} - Edges: {g.n_edges}",
        f"Max deg: {g.max_degree} - Min deg: {int(g.degrees.min()) if g.n else 0}"
        f" - Avg deg: {g.mean_degree}",
        f"Edge probability (for randomly generated graphs): "
        f"{prob if prob is not None else 0}",
        f"Seed: {seed}",
        "-------------------------------------------",
        "EXECUTION INFO",
        f"Repetition: {repetition}",
        f"Execution time: {coloring.duration_ms / 1e3}",
        f"Iteration performed: {coloring.iterations}",
        "Max iteration reached: "
        + ("yes" if coloring.extra.get("max_iter_reached") else "no"),
        "-------------------------------------------",
        "Color histogram:",
    ]
    lines += [f"{i}: {int(hist[i])}" for i in range(coloring.n_colors)]
    lines += [
        f"Number of colors: {coloring.n_colors} - Used colors: "
        f"{coloring.used_colors}",
        f"Color ratio: {num_color_ratio}",
        f"Average number of nodes for each color: {stats['mean']}",
        f"Variance: {stats['variance']}",
        f"StD: {stats['std']}",
    ]
    if prob is not None and prob > 0:
        lines.append(f"BalancingIndex {coloring.balance_index(prob)}")
    return "\n".join(lines) + "\n"


def save_run(
    out_dir: str,
    graph_name: str,
    algo: str,
    repetition: int,
    g: Graph,
    coloring: Coloring,
    *,
    seed: int,
    prob: float | None = None,
    num_color_ratio: float = 1.0,
) -> tuple[str, str]:
    """Write ``<name>-<ALGO>-<rep>.log`` and ``...-colors.txt``
    (reference main.cu:101-108,183-189; README.md:145).  Returns the two
    paths."""
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, f"{graph_name}-{algo}-{repetition}")
    log_path = base + ".log"
    colors_path = base + "-colors.txt"
    with open(log_path, "w") as f:
        f.write(
            format_run_stats(
                g,
                coloring,
                algo=algo,
                repetition=repetition,
                seed=seed,
                prob=prob,
                num_color_ratio=num_color_ratio,
            )
        )
    with open(colors_path, "w") as f:
        for i, c in enumerate(np.asarray(coloring.colors)):
            f.write(f"{i} {int(c)}\n")
    return log_path, colors_path
