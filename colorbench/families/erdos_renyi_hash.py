"""A hash-defined G(n, p): edge(i, j) iff mix32(seed, min, max) <
floor(p * 2**32).  The program generates it on the card from (n, p,
seed); the reference derives its edges again from the definition
(``reference/hashgraph.py``)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ResidentGraph:
    """What the program is handed: the graph's definition, no edges."""

    n: int
    p: float
    seed: int


def make(config: dict, seed: int) -> ResidentGraph:
    return ResidentGraph(config["n"], config["p"], seed)


def reference_edges(config: dict, graph: ResidentGraph, device):
    """(src, dst) int32 tensors on ``device``, src < dst."""
    from colorbench.reference.hashgraph import hash_edges

    return hash_edges(graph.n, graph.p, graph.seed, device)
