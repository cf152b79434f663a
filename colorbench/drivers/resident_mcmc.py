"""The resident chain over the hash graph:
``mcmc_colorer_tpu_torch.models.mcmc_resident.ResidentMCMCColorer``
(the hash adjacency generated on the card, kernel K1 a sweep, the NC
tailcut)."""

import numpy as np

from colorbench import faults

KERNELS = ("k1",)
COLORER = ("mcmc_colorer_tpu_torch.models.mcmc_resident", "ResidentMCMCColorer")
BALANCED = True  # the judge holds its colourings to the configuration's balance limits


def make(config: dict, job: dict, graph, device):
    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer

    params = MCMCParams(
        n_colors=0,  # max degree / numColRatio, measured on the card
        max_iterations=config["max_iterations"], epsilon=config["epsilon"],
        taboo_iterations=config["taboo_iterations"], tailcut=config["tailcut"],
        proposal=ProposalKind(config["proposal"]),
    )
    return ResidentMCMCColorer(graph.n, graph.p, graph.seed, params,
                               num_col_ratio=job["num_col_ratio"], device=device)


def run(colorer, seed: int, repetition: int) -> dict:
    r = colorer.run(seed, repetition)
    x = r.extra
    return {"colors": r.colors, "n_colors": r.n_colors, "conflicts": x["final_conflicts"],
            "sweeps": x["sweeps"], "chain_s": x["chain_seconds"],
            "tailcut_s": x["tailcut_seconds"], "gen_s": x["gen_seconds"],
            "rounds": r.iterations, "run_s": r.duration_ms / 1e3,
            "degrees": colorer.host_degrees}


def graph_state(colorer):
    """What the judge holds against the reference graph: the packed A."""
    return "packed", colorer.adj


neighbor_of = faults.packed_neighbor


def _skip_repair():
    """The NC tailcut left out: the chain's colouring, stopped at the
    tailcut threshold (the program calls at most max(50, n/2000)
    conflicts converged), returned as if repaired."""
    from mcmc_colorer_tpu_torch.models import mcmc_resident

    def tailcut(adj, colors, conflicts, sources, node_mask, **kw):
        c = colors.shape[0]
        return colors, np.zeros(c, np.int64), np.zeros(c, np.int64)

    return [(mcmc_resident, "_tailcut_nc", tailcut)]


FAULTS = {"skip_repair": _skip_repair, "skip_chain": faults.skip_chain}
# skip_chain is no control here: the NC tailcut cannot repair a chain's
# start, so the job runs its 16 + 2 * conflicts rounds and ends unfinished
CONTROLS = ("skip_repair",)
