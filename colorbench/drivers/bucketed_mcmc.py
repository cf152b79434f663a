"""The ELL chain over the degree-bucketed layout:
``mcmc_colorer_tpu_torch.models.mcmc.MCMCColorer(layout="bucketed")``
over the benchmark's edge list (the program relabels the graph by degree
and builds one rectangle a degree class; kernel K2 once a class a sweep,
K3's tailcut call and the lower-movable kernel once a class a round).
A job also returns the layout's ``classes`` (rectangles) and
``gather_ids`` (the neighbour ids a sweep reads).  The faults are the
flat ELL chain's (``ell_mcmc.py``)."""

import numpy as np
import torch

from colorbench import spec

_ell = spec.driver("ell", "mcmc")

KERNELS = ("k2", "k3")
COLORER = ("mcmc_colorer_tpu_torch.models.mcmc", "MCMCColorer")
BALANCED = True  # the judge holds its colourings to the configuration's balance limits
SLOTS_A_PIECE = 1 << 24  # slots turned into keys at once


def make(config: dict, job: dict, graph, device):
    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind, default_n_colors
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer

    g = graph.port_graph()
    params = MCMCParams(
        n_colors=default_n_colors(g.max_degree, job["num_col_ratio"]),
        max_iterations=config["max_iterations"], epsilon=config["epsilon"],
        taboo_iterations=config["taboo_iterations"], tailcut=config["tailcut"],
        proposal=ProposalKind(config["proposal"]),
    )
    return MCMCColorer(g, params, layout=config["layout"], device=device)


def run(colorer, seed: int, repetition: int) -> dict:
    r = colorer.run(seed, repetition)
    x = r.extra
    return {"colors": r.colors, "n_colors": r.n_colors, "conflicts": x["final_conflicts"],
            "sweeps": x["sweeps"], "chain_s": x["chain_seconds"],
            "tailcut_s": x["tailcut_seconds"], "rounds": r.iterations,
            "run_s": r.duration_ms / 1e3, "classes": x.get("classes"),
            "gather_ids": x.get("gather_ids")}


def _input_ids(colorer) -> torch.Tensor:
    """[n_pad] int64 on the layout's device: the input id of the vertex at
    each padded position, -1 at a phantom one."""
    ell = colorer.ell
    dev = ell.degrees.device
    out = torch.full((ell.n_pad,), -1, dtype=torch.int64, device=dev)
    out[torch.from_numpy(np.asarray(colorer._pos)).to(dev)] = torch.from_numpy(
        np.asarray(colorer._perm, dtype=np.int64)).to(dev)
    return out


def graph_state(colorer):
    """What the judge holds against the reference graph: the sorted keys
    a·n + b of every slot of every class but the padding (the sentinel
    n_pad), a and b the input ids of the row and of the id it holds; a
    slot whose row or id names no real vertex keeps the invalid key -1."""
    ell, n = colorer.ell, colorer.graph.n
    n_pad = ell.n_pad
    ids = _input_ids(colorer)
    keys = []
    for sl in ell.slices:
        step = max(1, SLOTS_A_PIECE // max(sl.d_pad, 1))
        for r0 in range(0, sl.h_pad, step):
            rows = sl.neighbors[r0:r0 + step]
            r, k = torch.nonzero(rows != n_pad, as_tuple=True)
            b_pos = rows[r, k].to(torch.int64)
            a = ids[sl.start + r0 + r]
            b = ids[b_pos.clamp(0, n_pad - 1)]
            ok = (a >= 0) & (b >= 0) & (b_pos >= 0) & (b_pos < n_pad)
            keys.append(torch.where(ok, a * n + b, -1))
    return "bucketed", torch.sort(torch.cat(keys)).values


def neighbor_of(colorer, v: int) -> int | None:
    """A neighbour of input vertex ``v``: the first id of its row in its
    degree class, mapped back to the input's ids."""
    perm, pos = np.asarray(colorer._perm), np.asarray(colorer._pos)
    p = int(pos[int(np.flatnonzero(perm == v)[0])])
    sl = next(s for s in colorer.ell.slices if s.start <= p < s.start + s.h_pad)
    row = sl.neighbors[p - sl.start].cpu().numpy()
    real = row[row < colorer.ell.n_pad]
    if real.size == 0:
        return None
    k = int(np.searchsorted(pos, int(real[0])))
    return int(perm[k]) if k < pos.size and pos[k] == real[0] else None


FAULTS = _ell.FAULTS
CONTROLS = _ell.CONTROLS
