"""GreedyFF over the benchmark's edge list, the CLI's default mode:
``mcmc_colorer_tpu_torch.models.greedy_ff.GreedyFFColorer`` (flat ELL,
kernel K3 a band a round)."""

from colorbench import faults

KERNELS = ("k3",)
COLORER = ("mcmc_colorer_tpu_torch.models.greedy_ff", "GreedyFFColorer")
BALANCED = False


def make(config: dict, job: dict, graph, device):
    from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer

    return GreedyFFColorer(graph.port_graph(), layout=config["layout"], device=device)


def run(colorer, seed: int, repetition: int) -> dict:
    r = colorer.run(seed, repetition)
    return {"colors": r.colors, "n_colors": r.n_colors, "conflicts": 0,
            "rounds": r.iterations, "run_s": r.duration_ms / 1e3}


def graph_state(colorer):
    return "ell", colorer.ell.neighbors


neighbor_of = faults.ell_neighbor


FAULTS = {"skip_losers": faults.skip_losers}
CONTROLS = ("skip_losers",)
