"""Faults planted in the program under test, for the controls and the
fault tests: each breaks one guarantee, and the judge (``check.py``)
has to find it.  They patch the program in this process only; nothing
on disk changes.

A colourer's own faults, and which of them are its controls, sit in its
driver (``drivers/<path>_<colorer>.py``: ``FAULTS``, ``CONTROLS``).
The faults every colourer can have are here, applied to the colours its
``run`` returns (the driver's ``COLORER``):

- ``unchanged_state``: the colourer returns the colouring it starts from
  (every vertex in class 0), no step applied;
- ``half_batch``: the colours of the second half of the vertices are
  left at that start;
- ``altered_answer``: one vertex's colour is replaced, where the
  colourer produces it, by the colour of one of its neighbours
  (the driver's ``neighbor_of``).

Faults that several drivers share, named in their ``FAULTS``:

- ``skip_chain`` (the chain drivers): the chain run for 0 sweeps (its
  state left as it starts), then the tailcut as usual;
- ``skip_losers`` (GreedyFF, and VFF, whose first phase is GreedyFF's):
  the conflict test finds no loser, so the first tentative colouring is
  returned.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np


@contextlib.contextmanager
def _patched(pairs):
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in pairs]
    try:
        for obj, attr, new in pairs:
            setattr(obj, attr, new)
        yield
    finally:
        for obj, attr, old in reversed(saved):
            setattr(obj, attr, old)


def skip_chain():
    """Every chain's segments driven for 0 sweeps: the chain hands its
    initial colouring to the tailcut, which repairs it."""
    from mcmc_colorer_tpu_torch.utils import segmented

    def no_sweeps(segment_fn, state, progress_fn, **kw):
        return state

    return [(segmented, "drive_segments", no_sweeps)]


def skip_losers():
    import torch

    from mcmc_colorer_tpu_torch.models import greedy_ff

    def none_lose(ell, colors):
        return torch.zeros((ell.n_pad,), dtype=torch.bool, device=colors.device)

    return [(greedy_ff, "_conflict_losers", none_lose)]


def packed_neighbor(colorer, v: int) -> int | None:
    """A neighbour of vertex ``v`` in the colourer's bit-packed A (word w,
    bit b hold column (w // 128) * 4096 + b * 128 + w % 128)."""
    words = colorer.adj[v].cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    nz = np.flatnonzero(words)
    if nz.size == 0:
        return None
    w = int(nz[0])
    b = int(np.flatnonzero((words[w] >> np.arange(32)) & 1)[0])
    return (w // 128) * 4096 + b * 128 + w % 128


def ell_neighbor(colorer, v: int) -> int | None:
    """A neighbour of vertex ``v`` in the colourer's ELL rows."""
    u = int(colorer.ell.neighbors[v, 0])
    return u if u < colorer.graph.n else None


def _on_output(edit, drivers):
    """Wrap each driver's colourer's ``run`` so that ``edit(driver,
    colorer, colors)`` changes the colours it returns."""
    pairs, seen = [], set()
    for d in drivers:
        mod, cls = d.COLORER
        if (mod, cls) in seen:
            continue
        seen.add((mod, cls))
        klass = getattr(importlib.import_module(mod), cls)
        orig = klass.run

        def run(self, *a, _orig=orig, _d=d, **kw):
            r = _orig(self, *a, **kw)
            r.colors = edit(_d, self, np.array(r.colors))
            return r

        pairs.append((klass, "run", run))
    return pairs


def _unchanged(driver, colorer, colors):
    return np.zeros_like(colors)


def _half(driver, colorer, colors):
    colors[colors.shape[0] // 2:] = 0
    return colors


def _altered(driver, colorer, colors):
    for v in range(colors.shape[0]):
        u = driver.neighbor_of(colorer, v)
        if u is not None:
            colors[v] = colors[u]
            return colors
    return colors


ON_OUTPUT = {"unchanged_state": _unchanged, "half_batch": _half, "altered_answer": _altered}


def controls(drivers) -> list[str]:
    """The controls of a cell: its drivers' ``CONTROLS``, in order."""
    out: list[str] = []
    for d in drivers:
        out += [c for c in d.CONTROLS if c not in out]
    return out


def planted(name: str, drivers):
    """A context in which the program runs with fault ``name``, planted in
    every one of ``drivers`` (a cell's) that can have it."""
    if name in ON_OUTPUT:
        return _patched(_on_output(ON_OUTPUT[name], drivers))
    pairs, seen = [], set()
    for d in drivers:
        if name in d.FAULTS:
            for obj, attr, new in d.FAULTS[name]():
                if (id(obj), attr) not in seen:
                    seen.add((id(obj), attr))
                    pairs.append((obj, attr, new))
    if not pairs:
        raise KeyError(f"no driver of this cell has the fault {name!r}")
    return _patched(pairs)
