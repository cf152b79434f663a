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

Over a ``parallel/mesh.Mesh`` (JAX's ``mesh`` with a ``chains`` axis),
chain group g runs chains [g·k, (g+1)·k), k = n_chains / mesh.chains,
each from its own source as above, so chain c is the same chain on any
mesh; the ranks of a group (its shards) run the same chains, as JAX
replicates them over ``shards``.  The chains run without a collective;
after them one ``gather_objects`` brings every group's per-chain
statistics to every rank, which all pick the same best chain, and its
group's first rank broadcasts that chain's colours and trace.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mcmc_colorer_tpu_torch.config import MCMCParams
from mcmc_colorer_tpu_torch.graph.container import Graph
from mcmc_colorer_tpu_torch.models.base import Coloring, colors_in_input_order
from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer, choose_block_size
from mcmc_colorer_tpu_torch.utils.rng import ChainSources


def class_stds(colors: np.ndarray, n_colors: int) -> np.ndarray:
    """Each chain's class-size std over the palette."""
    return np.array([np.bincount(c, minlength=n_colors).std() for c in colors])


def pick_best(stds, conflicts, rips):
    """(best chain, summaries): fewest conflicts, then the smallest
    class-size std (``np.lexsort``, as JAX)."""
    stds, conflicts, rips = np.asarray(stds), np.asarray(conflicts), np.asarray(rips)
    best = int(np.lexsort((stds, conflicts))[0])
    summaries = [
        {"chain": i, "iterations": int(rips[i]), "conflicts": int(conflicts[i]),
         "class_std": float(stds[i])}
        for i in range(len(stds))
    ]
    return best, summaries


class EnsembleMCMCColorer:
    """Run ``n_chains`` independent chains, return the best colouring and
    per-chain summaries.  ``backend``, ``layout`` and ``device`` as
    ``MCMCColorer``'s (whose layout it builds, with JAX's ensemble block
    ``choose_block_size(n, nCol · max(1, n_chains // 8))``).  ``mesh``
    (``parallel/mesh.make_mesh``) spreads the chains over its chain
    groups, on its device; ``n_chains`` must be a multiple of
    ``mesh.chains``.  A mesh without a process group (1x1) runs as
    ``mesh=None``."""

    def __init__(
        self,
        graph: Graph,
        params: MCMCParams,
        n_chains: int,
        mesh=None,
        block_size: int | None = None,
        backend: str = "auto",
        layout: str = "flat",
        device="cuda",
    ) -> None:
        if n_chains < 1:
            raise ValueError(f"n_chains={n_chains} must be positive")
        self.local_chains, self.first_chain = n_chains, 0
        if mesh is not None:
            if "chains" not in getattr(mesh, "shape", {}):
                raise ValueError("mesh must have a 'chains' axis")
            if n_chains % mesh.chains:
                raise ValueError(
                    f"n_chains={n_chains} not divisible by mesh chains={mesh.chains}")
            self.local_chains = n_chains // mesh.chains
            self.first_chain = mesh.chain_index * self.local_chains
            device = mesh.device
        block = block_size or choose_block_size(
            graph.n, params.n_colors * max(1, n_chains // 8))
        if layout == "bucketed" and block_size is None:
            block = min(block, 2048)
        self.colorer = MCMCColorer(graph, params, block_size=block, backend=backend,
                                   layout=layout, device=device)
        self.graph, self.params, self.n_chains, self.mesh = graph, params, n_chains, mesh
        self.backend, self.layout = self.colorer.backend, layout
        self.device, self.block, self.ell = self.colorer.device, block, self.colorer.ell

    def run(self, seed: int, repetition: int = 0, sources=None):
        """Returns (best Coloring, list of per-chain summaries over all
        ``n_chains``), the same on every rank of a mesh.  ``sources``
        (tests) replaces this rank's chains' sources
        (``utils/rng.ChainSources``)."""
        params, c, k = self.params, self.colorer, self.local_chains
        sources = sources or ChainSources.seeded(seed, repetition, k, self.device,
                                                 first=self.first_chain)
        if len(sources) != k:
            raise ValueError(f"{len(sources)} sources for this rank's {k} chains")
        state, colors, conflicts, tc_rounds, chain_s, t0 = c.run_chains(sources)
        out = np.stack([colors_in_input_order(colors[i], self.graph.n, c._perm, c._pos)
                        for i in range(k)])
        local = {"conflicts": np.asarray(conflicts), "rips": np.asarray(state.rip),
                 "stds": class_stds(out, params.n_colors), "tc_rounds": np.asarray(tc_rounds),
                 "bodies": state.bodies}
        groups = [local]
        if self.mesh is not None:  # each chain group's first shard, in group order
            groups = self.mesh.gather_objects(local)[::self.mesh.shards]
        stats = {key: np.concatenate([g[key] for g in groups]) for key in local if key != "bodies"}
        rips, conflicts = stats["rips"], stats["conflicts"]
        best, summaries = pick_best(stats["stds"], conflicts, rips)
        trace_len = int(rips[best]) + 1
        owner, lb = divmod(best, k)
        if owner == self.first_chain // k:
            best_colors = out[lb]
            best_trace = state.trace[lb, :trace_len].astype(np.int64)
        else:
            best_colors = np.zeros(self.graph.n, np.int32)
            best_trace = np.zeros(trace_len, np.int64)
        if self.mesh is not None:
            payload = torch.from_numpy(np.concatenate([best_colors, best_trace])).to(self.device)
            payload = self.mesh.broadcast(payload, owner * self.mesh.shards).cpu().numpy()
            best_colors = payload[:self.graph.n].astype(np.int32)
            best_trace = payload[self.graph.n:]
        dur = (time.perf_counter() - t0) * 1e3
        z = params.tailcut_threshold(self.graph.n)
        best_coloring = Coloring(
            colors=best_colors,
            n_colors=params.n_colors,
            iterations=int(rips[best]),
            converged=int(conflicts[best]) <= z,
            duration_ms=dur,
            conflict_trace=best_trace,
            extra={
                "final_conflicts": int(conflicts[best]),
                "max_iter_reached": bool(rips[best] >= params.max_iterations),
                "best_chain": best,
                "n_chains": self.n_chains,
                "tailcut_rounds": int(stats["tc_rounds"][best]),
                # batched bodies (one K2 or K1 launch a rectangle each) of
                # the longest chain group
                "sweeps": max(g["bodies"] for g in groups),
                "chain_seconds": chain_s,
            },
        )
        return best_coloring, summaries
