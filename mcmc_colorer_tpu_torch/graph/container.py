"""Host CSR graph (the subset of ``graph/container.py:Graph`` the port needs)."""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np


@dataclass
class Graph:
    """CSR over node ids 0..n-1 with both directions of every undirected
    edge present in ``cols``."""

    n: int
    row_ptr: np.ndarray          # (n+1,) int64
    cols: np.ndarray             # (2m,) int32
    name: str = "graph"

    @cached_property
    def degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr).astype(np.int32)

    @property
    def n_edges(self) -> int:
        """Number of undirected edges (each stored twice in ``cols``)."""
        return int(self.cols.shape[0]) // 2

    @cached_property
    def max_degree(self) -> int:
        return int(self.degrees.max()) if self.n else 0
