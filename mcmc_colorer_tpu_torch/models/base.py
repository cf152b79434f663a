"""Colorer output type and validity check (counterpart of ``models/base.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mcmc_colorer_tpu_torch.graph.container import Graph


@dataclass
class Coloring:
    """Result of a colorer: ``colors[i]`` is the 0-based colour of node i;
    ``n_colors`` the palette size the run used; the rest is execution
    metadata."""

    colors: np.ndarray
    n_colors: int
    iterations: int = 0
    converged: bool = True
    duration_ms: float = 0.0
    conflict_trace: np.ndarray | None = None
    extra: dict = field(default_factory=dict)


def check_coloring(g: Graph, colors: np.ndarray, allow_uncolored: bool = False) -> bool:
    """Validity check: no edge joins two same-coloured nodes (reference
    colorer.cpp:117-132, vectorised over the CSR)."""
    colors = np.asarray(colors)
    u = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees)
    v = g.cols.astype(np.int64)
    same = colors[u] == colors[v]
    if allow_uncolored:
        same &= colors[u] >= 0
    return not bool(same.any())
