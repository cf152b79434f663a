"""Stepped chain: inspection, live ε editing, checkpoint and resume.

Counterpart of ``mcmc_colorer_tpu/models/chain_api.py``.  The chain loop
lives on the host, so the state can be read, edited and saved between
segments:

- ``ChainState``: colours, taboo, the uniform source's generator state,
  the iteration and the conflicts of the current colouring;
- ``SteppedMCMC.step(state, n, epsilon=)``: up to n sweeps, ε overridden
  for them (the reference debugger's live edit, dbg.cpp:358-381);
- ``inspect(state)``: the debugger's print set (violations, histogram,
  free-colour min/max/avg, class sizes);
- ``save_checkpoint`` / ``load_checkpoint``: the state in an ``.npz``.

The stepped body is JAX's ``_step_segment`` (chain_api.py:371-449), not
``MCMCColorer``'s do-while: a body runs only while the conflicts exceed
the threshold, draws its uniforms (and, under Hastings, the acceptance
uniform) only when it runs, and counts the conflicts of the star
colouring after the sweep: it is the generic loop's body
(``models/mcmc.py:_chain_body_generic``, the chain core at C = 1).

Backends: ``auto`` means ``pallas`` here, kernel K2 on the card (its
plain version on CPU tensors), as ``MCMCColorer``'s ``auto`` does; JAX's
``auto`` picks its plain ``xla`` sweep on a CPU or GPU
(chain_api.py:81-86).  ``xla`` runs K2's plain version.  The tailcut's
first fit is kernel K3 on CUDA tensors.

Checkpoints hold JAX's ``.npz`` keys but one: where JAX stores its key
(``key``, ``jax.random.key_data``), the port stores its generator's
state (``generator_state``).  So the port resumes its own chain bit for
bit, and refuses a JAX checkpoint.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from mcmc_colorer_tpu_torch.config import MCMCParams
from mcmc_colorer_tpu_torch.graph.container import Graph
from mcmc_colorer_tpu_torch.models.base import Coloring, colors_in_input_order
from mcmc_colorer_tpu_torch.models.mcmc import (
    ChainState as _Carry,
    MCMCColorer,
    _chain_body_generic,
    _chain_segment,
    _conflict_edges,
    _init_colors,
    _row_blocks,
    _tailcut,
)
from mcmc_colorer_tpu_torch.ops.neighbor import color_histogram, neighbor_colors, occupancy_matrix
from mcmc_colorer_tpu_torch.utils.rng import ChainSources, TorchUniformSource

GENERATOR_KEY = "generator_state"


@dataclass
class ChainState:
    colors: torch.Tensor    # [n_pad] int32
    taboo: torch.Tensor     # [n_pad] int32
    rng: torch.Tensor       # the source's generator state (uint8, on the CPU)
    iteration: int
    conflicts: int          # conflict edges of ``colors``


def refuse_jax_checkpoint(d, path: str) -> None:
    """A JAX checkpoint stores a ``jax.random`` key, which the port's
    generator cannot continue: refuse it."""
    if GENERATOR_KEY not in d.files:
        raise ValueError(
            f"{path}: no {GENERATOR_KEY!r} entry"
            + (" (it holds a jax.random 'key': a checkpoint of the JAX package)"
               if "key" in d.files else "")
            + "; the port resumes only its own checkpoints, which store its "
            "torch.Generator state"
        )


def npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_npz_atomic(path: str, **arrays) -> None:
    """Write to a temporary file, then rename it into place: a kill during
    the write leaves the previous checkpoint whole."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, npz_path(path))


def _step_segment(ell, carry: _Carry, sources, eps, n_steps: int, *, params: MCMCParams,
                  block: int, backend: str) -> _Carry:
    """``n_steps`` stepped bodies (JAX ``_step_segment``): the generic
    loop's body on the carry, each run only while the conflicts of the
    current colouring exceed the threshold."""
    body = partial(_chain_body_generic, params=params, block=block, backend=backend,
                   sources=sources, eps=eps)
    return _chain_segment(ell, carry, n_steps, params=params, n_nodes=ell.n_nodes,
                          fused=False, body=body, cap=carry.rip + n_steps)


class SteppedMCMC:
    """Host-driven stepped execution of the MCMC chain over a host graph
    laid out on ``device`` (the current CUDA device by default), flat or
    degree-bucketed (``layout="bucketed"``)."""

    def __init__(
        self,
        graph: Graph,
        params: MCMCParams,
        block_size: int | None = None,
        backend: str = "auto",
        layout: str = "flat",
        device="cuda",
    ) -> None:
        backend = "pallas" if backend == "auto" else backend
        if backend not in ("pallas", "xla"):
            raise ValueError(f"the stepped chain runs backend 'pallas' or 'xla', not {backend!r}")
        self._layout = MCMCColorer(graph, params, block_size=block_size, backend=backend,
                                   layout=layout, device=device)
        self.graph, self.params, self.backend, self.layout = graph, params, backend, layout
        self.ell, self.block, self.device = self._layout.ell, self._layout.block, self._layout.device

    def init_state(self, seed: int, repetition: int = 0) -> ChainState:
        source = TorchUniformSource(seed, repetition, self.device)
        ell = self.ell
        colors = _init_colors(ell.n_pad, ell.n_nodes, self.params, source, self.device,
                              ell.node_mask)
        return ChainState(colors, torch.zeros_like(colors), source.get_state(), 0,
                          int(_conflict_edges(ell, colors[None])[0]))

    def _sources(self, state: ChainState) -> ChainSources:
        source = TorchUniformSource(0, 0, self.device)
        source.set_state(state.rng)
        return ChainSources([source], self.device)

    def step(self, state: ChainState, n_steps: int = 1, epsilon: float | None = None) -> ChainState:
        """Advance up to ``n_steps`` sweeps (a converged chain stops
        resampling; JAX ``_step_segment``).  ``epsilon`` overrides
        ``params.epsilon`` for them."""
        sources = self._sources(state)
        one = np.ones(1, np.int64)  # the chain core at one chain
        carry = _Carry(state.colors[None], state.taboo[None], one * state.iteration,
                       one * state.conflicts, None, np.zeros(1, bool))
        carry = _step_segment(self.ell, carry, sources, epsilon, n_steps, params=self.params,
                              block=self.block, backend=self.backend)
        return ChainState(carry.colors[0], carry.taboo[0], sources.get_state()[0],
                          int(carry.rip[0]), int(carry.conf_last[0]))

    def run(self, seed: int, repetition: int = 0, segment: int | None = None,
            checkpoint_path: str | None = None, resume_from: str | None = None,
            dbg=None) -> Coloring:
        """A whole run in host-visible segments: ``segment`` sweeps each, or
        lengths chosen by ``utils/segmented.py`` (None); a checkpoint after
        each segment where ``checkpoint_path`` is given; resumed from
        ``resume_from`` if given.  ``dbg`` (a ``utils/dbg.DebugAttach``) is
        polled at every segment boundary: on a break-in its shell runs
        against this chain, its ε edit applies to the following segments,
        and 'q' ends the run where it is."""
        from mcmc_colorer_tpu_torch.utils.segmented import drive_segments

        t0 = time.perf_counter()
        state = self.load_checkpoint(resume_from) if resume_from else self.init_state(
            seed, repetition)
        params = self.params
        z = params.tailcut_threshold(self.graph.n)
        maxr = params.max_iterations
        aborted = False

        def seg_fn(st, n):
            n = max(1, min(n, maxr - st.iteration))
            return self.step(st, n, epsilon=dbg.epsilon if dbg is not None else None)

        def progress(st):
            return st.iteration, aborted or st.conflicts <= z or st.iteration >= maxr

        def on_segment(st, *_):
            nonlocal aborted
            if checkpoint_path:
                self.save_checkpoint(st, checkpoint_path)
            if dbg is not None and dbg.pending():
                dbg.break_in(self, st)
                aborted = aborted or dbg.quit

        fixed = {} if segment is None else {"init_budget": segment, "fixed": True}
        state = drive_segments(seg_fn, state, progress, on_segment=on_segment, **fixed)
        colors, conflicts, tc_rounds = state.colors, state.conflicts, 0
        if params.tailcut and conflicts > 0:
            out, conf, rounds = _tailcut(self.ell, colors[None], np.array([conflicts]),
                                         self._sources(state), params=params)
            colors, conflicts, tc_rounds = out[0], int(conf[0]), int(rounds[0])
        rip = state.iteration
        return Coloring(
            colors=colors_in_input_order(colors, self.graph.n, self._layout._perm,
                                         self._layout._pos),
            n_colors=params.n_colors,
            iterations=rip,
            converged=conflicts <= z,
            duration_ms=(time.perf_counter() - t0) * 1e3,
            extra={"final_conflicts": conflicts, "max_iter_reached": rip >= maxr,
                   "tailcut_rounds": tc_rounds},
        )

    # ---- inspection (the debugger's print set, dbg.cpp:113-158) ----

    def inspect(self, state: ChainState) -> dict:
        """Violation counts, histogram and free-colour stats of ``state``
        over every real vertex (the reference's getStatsFreeColors,
        coloringMCMC_prints.cu:117-131), in row blocks."""
        ell, n_colors, colors = self.ell, self.params.n_colors, state.colors
        dev = colors.device
        mins, maxs, sums, viol = [], [], [], []
        for s, neigh in _row_blocks(ell):
            e = s + neigh.shape[0]
            nc = neighbor_colors(neigh, colors)
            zp = n_colors - occupancy_matrix(nc, n_colors).sum(1)
            real = ell.node_mask[s:e]
            mins.append(torch.where(real, zp, n_colors + 1).min())
            maxs.append(torch.where(real, zp, -1).max())
            sums.append(torch.where(real, zp, 0).sum())
            viol.append(((nc == colors[s:e, None]).any(1) & real).sum())
        mn, mx, total, n_viol, taboo = torch.stack([
            torch.stack(mins).min(), torch.stack(maxs).max(), torch.stack(sums).sum(),
            torch.stack(viol).sum(), (state.taboo > 0).sum().to(dev),
        ]).tolist()
        h = color_histogram(colors, n_colors, ell.node_mask).cpu().numpy()
        return {
            "iteration": int(state.iteration),
            "conflict_edges": int(state.conflicts),
            "violating_nodes": n_viol,
            "taboo_active": taboo,
            "histogram": h,
            "used_colors": int((h > 0).sum()),
            "class_std": float(h.std()),
            "free_colors_min": mn,
            "free_colors_max": mx,
            "free_colors_avg": total / self.graph.n,
        }

    # ---- checkpoints ----

    def save_checkpoint(self, state: ChainState, path: str) -> None:
        save_npz_atomic(
            path,
            colors=state.colors.cpu().numpy(),
            taboo=state.taboo.cpu().numpy(),
            **{GENERATOR_KEY: state.rng.cpu().numpy()},
            iteration=int(state.iteration),
            conflicts=int(state.conflicts),
            n_colors=self.params.n_colors,
            n_nodes=self.graph.n,
            layout=self.layout,
        )

    def load_checkpoint(self, path: str) -> ChainState:
        path = npz_path(path)
        d = np.load(path)
        refuse_jax_checkpoint(d, path)
        if int(d["n_nodes"]) != self.graph.n:
            raise AssertionError("graph mismatch")
        if int(d["n_colors"]) != self.params.n_colors:
            raise AssertionError("palette mismatch")
        # colours are stored in the layout's padded order, so layouts must match
        if str(d["layout"]) != self.layout:
            raise AssertionError("layout mismatch")
        dev = self.device
        return ChainState(
            colors=torch.from_numpy(d["colors"]).to(dev),
            taboo=torch.from_numpy(d["taboo"]).to(dev),
            rng=torch.from_numpy(d[GENERATOR_KEY]),
            iteration=int(d["iteration"]),
            conflicts=int(d["conflicts"]),
        )
