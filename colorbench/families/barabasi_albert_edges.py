"""The benchmark's own seeded Barabási–Albert edge list
(``reference/ba_edges.py``), handed to the program as a host graph
(``Graph.from_edges``, the reference's ``--graph`` path), which lays it
out itself.  Both sides read the same arrays."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class EdgeListGraph:
    n: int
    m: int
    seed: int
    src: np.ndarray
    dst: np.ndarray
    _port: object = None

    def port_graph(self):
        """The program's ``Graph`` of these edges, built once."""
        if self._port is None:
            from mcmc_colorer_tpu_torch.graph.container import Graph

            self._port = Graph.from_edges(self.n, self.src, self.dst,
                                          name=f"ba_{self.n}_{self.m}")
        return self._port


def make(config: dict, seed: int) -> EdgeListGraph:
    from colorbench.reference.ba_edges import ba_edges

    src, dst = ba_edges(config["n"], config["m_per_vertex"], seed)
    return EdgeListGraph(config["n"], config["m_per_vertex"], seed, src, dst)


def reference_edges(config: dict, graph: EdgeListGraph, device):
    """(src, dst) int32 tensors on ``device``: the raw edge list."""
    import torch

    return torch.from_numpy(graph.src).to(device), torch.from_numpy(graph.dst).to(device)
