"""Sequential greedy first-fit colorer (numpy; a copy of
``mcmc_colorer_tpu/models/greedy_seq.py``).

Counterpart of the reference's ``ColoringGreedyCPU`` (colorer.cpp:135-208):
visit vertices in ascending-degree order (colorer.cpp:163), assign each the
first color class containing no neighbor.  In the reference this class is
not reachable from the CLI (SURVEY §2.1); here it is exposed as
``greedy_seq``.
"""

from __future__ import annotations

import time

import numpy as np

from mcmc_colorer_tpu_torch.graph.container import Graph
from mcmc_colorer_tpu_torch.models.base import Coloring


class SequentialGreedyColorer:
    def __init__(self, graph: Graph) -> None:
        self.graph = graph

    def run(self, seed: int = 0, repetition: int = 0) -> Coloring:
        g = self.graph
        t0 = time.perf_counter()
        order = np.argsort(g.degrees, kind="stable")  # ascending degree
        colors = np.full(g.n, -1, dtype=np.int64)
        max_colors = g.max_degree + 1
        for i in order:
            neigh = g.neighbors_of(i)
            occupied = np.zeros(max_colors + 1, dtype=bool)
            nc = colors[neigh]
            occupied[nc[nc >= 0]] = True
            colors[i] = int(np.argmin(occupied))
        dur = (time.perf_counter() - t0) * 1e3
        used = int(np.unique(colors).shape[0])
        return Coloring(
            colors=colors.astype(np.int32),
            n_colors=used,
            iterations=1,
            converged=True,
            duration_ms=dur,
        )
