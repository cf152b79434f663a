"""The ELL chain over the benchmark's edge list:
``mcmc_colorer_tpu_torch.models.mcmc.MCMCColorer`` (flat ELL, kernel K2 a
sweep, kernel K3 in the tailcut)."""

import numpy as np

from colorbench import faults

KERNELS = ("k2", "k3")
COLORER = ("mcmc_colorer_tpu_torch.models.mcmc", "MCMCColorer")
BALANCED = True  # the judge holds its colourings to the configuration's balance limits


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
            "run_s": r.duration_ms / 1e3}


def graph_state(colorer):
    """What the judge holds against the reference graph: the ELL rows."""
    return "ell", colorer.ell.neighbors


neighbor_of = faults.ell_neighbor


def _skip_repair():
    """The K3 tailcut left out: the chain's colouring, stopped at the
    tailcut threshold, returned as if repaired."""
    from mcmc_colorer_tpu_torch.models import mcmc

    def tailcut(ell_graph, colors, conflicts, sources, **kw):
        c = colors.shape[0]
        return colors, np.zeros(c, np.int64), np.zeros(c, np.int64)

    return [(mcmc, "_tailcut", tailcut)]


FAULTS = {"skip_repair": _skip_repair, "skip_chain": faults.skip_chain}
CONTROLS = ("skip_repair", "skip_chain")
