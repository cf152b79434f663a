"""The ELL chain over the hash graph with no host CSR:
``mcmc_colorer_tpu_torch.models.mcmc.MCMCColorer`` over
``graph.container.HashGraph`` (kernel K5 builds the flat ELL on the card
from the graph's definition; K2 a sweep, K3 in the tailcut).  One
``HashGraph`` a graph input, shared by every job on it, so the ELL is
built once.  What a job returns, the graph judged, the neighbour a fault
takes and the faults are the edge-list ELL chain's (``ell_mcmc.py``).

The program has to bring ``HashGraph``: there is no fallback to a host
enumerator (10^12 pair tests at config 3), so without it this driver
fails at import."""

from mcmc_colorer_tpu_torch.graph.container import HashGraph

from colorbench import spec

_ell = spec.driver("ell", "mcmc")

KERNELS = ("k2", "k3", "k5")
COLORER = ("mcmc_colorer_tpu_torch.models.mcmc", "MCMCColorer")
BALANCED = True  # the judge holds its colourings to the configuration's balance limits


def program_graph(graph, device) -> HashGraph:
    """The ``HashGraph`` of a graph input (``families/erdos_renyi_hash.py``),
    made once and kept on the input for the jobs that colour it."""
    g = vars(graph).get("_program_graph")
    if g is None:
        g = graph._program_graph = HashGraph(graph.n, graph.p, graph.seed, device=device)
    return g


def make(config: dict, job: dict, graph, device):
    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind, default_n_colors
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer

    g = program_graph(graph, device)
    params = MCMCParams(
        n_colors=default_n_colors(g.max_degree, job["num_col_ratio"]),
        max_iterations=config["max_iterations"], epsilon=config["epsilon"],
        taboo_iterations=config["taboo_iterations"], tailcut=config["tailcut"],
        proposal=ProposalKind(config["proposal"]),
    )
    return MCMCColorer(g, params, layout=config["layout"], device=device)


run = _ell.run
graph_state = _ell.graph_state
neighbor_of = _ell.neighbor_of
FAULTS = _ell.FAULTS
CONTROLS = _ell.CONTROLS
