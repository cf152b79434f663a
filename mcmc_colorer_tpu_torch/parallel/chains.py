"""Independent-chain MCMC ensemble on one card.

Counterpart of ``mcmc_colorer_tpu/parallel/chains.py``.  JAX vmaps its
device chain over the chains; the port's chain core has the chain axis
written out (``models/mcmc.py``, ``MCMCColorer.run_chains``): one state
[C, n_pad], each sweep one batched launch for all chains, K2 over the ELL (``pallas``) or its plain
version (``xla``), K1 over a packed A (``matmul``/``packed``, flat
layout only, as in JAX), and the tailcut's first fit one batched K3 a
row block.  Finished chains stay frozen in place and stop drawing, so
chain c ends exactly where ``MCMCColorer.run`` fed chain c's source
(``utils/rng.TorchUniformSource(seed, repetition, device, chain=c)``)
ends.  Best-of-chains picks the chain with the fewest conflicts, then the
smallest class-size std.

JAX's ``mesh`` (chains over several devices) is not a parameter here:
meshes are ROADMAP.md Queue 1 item 12.
"""

from __future__ import annotations

import time

import numpy as np

from mcmc_colorer_tpu_torch.config import MCMCParams
from mcmc_colorer_tpu_torch.graph.container import Graph
from mcmc_colorer_tpu_torch.models.base import Coloring, colors_in_input_order
from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer, choose_block_size
from mcmc_colorer_tpu_torch.utils.rng import ChainSources


def best_of_chains(colors: np.ndarray, conflicts, rips, n_colors: int):
    """(best chain, class-size stds, summaries): fewest conflicts, then
    the smallest class-size std (``np.lexsort``, as JAX)."""
    conflicts, rips = np.asarray(conflicts), np.asarray(rips)
    stds = np.array([np.bincount(c, minlength=n_colors).std() for c in colors])
    best = int(np.lexsort((stds, conflicts))[0])
    summaries = [
        {"chain": i, "iterations": int(rips[i]), "conflicts": int(conflicts[i]),
         "class_std": float(stds[i])}
        for i in range(len(colors))
    ]
    return best, summaries


class EnsembleMCMCColorer:
    """Run ``n_chains`` independent chains, return the best colouring and
    per-chain summaries.  ``backend``, ``layout`` and ``device`` as
    ``MCMCColorer``'s (whose layout it builds, with JAX's ensemble block
    ``choose_block_size(n, nCol · max(1, n_chains // 8))``)."""

    def __init__(
        self,
        graph: Graph,
        params: MCMCParams,
        n_chains: int,
        block_size: int | None = None,
        backend: str = "auto",
        layout: str = "flat",
        device="cuda",
    ) -> None:
        if n_chains < 1:
            raise ValueError(f"n_chains={n_chains} must be positive")
        block = block_size or choose_block_size(
            graph.n, params.n_colors * max(1, n_chains // 8))
        if layout == "bucketed" and block_size is None:
            block = min(block, 2048)
        self.colorer = MCMCColorer(graph, params, block_size=block, backend=backend,
                                   layout=layout, device=device)
        self.graph, self.params, self.n_chains = graph, params, n_chains
        self.backend, self.layout = self.colorer.backend, layout
        self.device, self.block, self.ell = self.colorer.device, block, self.colorer.ell

    def run(self, seed: int, repetition: int = 0, sources=None):
        """Returns (best Coloring, list of per-chain summaries).  ``sources``
        (tests) replaces the chains' sources (``utils/rng.ChainSources``)."""
        params, c = self.params, self.colorer
        sources = sources or ChainSources.seeded(seed, repetition, self.n_chains, self.device)
        state, colors, conflicts, tc_rounds, chain_s, t0 = c.run_chains(sources)
        out = np.stack([colors_in_input_order(colors[k], self.graph.n, c._perm, c._pos)
                        for k in range(self.n_chains)])
        dur = (time.perf_counter() - t0) * 1e3
        rips = state.rip
        best, summaries = best_of_chains(out, conflicts, rips, params.n_colors)
        z = params.tailcut_threshold(self.graph.n)
        best_coloring = Coloring(
            colors=out[best],
            n_colors=params.n_colors,
            iterations=int(rips[best]),
            converged=int(conflicts[best]) <= z,
            duration_ms=dur,
            conflict_trace=state.trace[best, : int(rips[best]) + 1].astype(np.int64),
            extra={
                "final_conflicts": int(conflicts[best]),
                "max_iter_reached": bool(rips[best] >= params.max_iterations),
                "best_chain": best,
                "n_chains": self.n_chains,
                "tailcut_rounds": int(tc_rounds[best]),
                "sweeps": state.bodies,  # batched bodies: one K2 or K1 launch a rectangle each
                "chain_seconds": chain_s,
            },
        )
        return best_coloring, summaries
