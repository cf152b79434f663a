"""VFF over the benchmark's edge list, the CLI's default mode:
``mcmc_colorer_tpu_torch.models.vff.VFFColorer`` (GreedyFF, then the
rebalancing rounds, kernel K3 with allow and cur)."""

from colorbench import faults

KERNELS = ("k3",)
COLORER = ("mcmc_colorer_tpu_torch.models.vff", "VFFColorer")
BALANCED = False


def make(config: dict, job: dict, graph, device):
    from mcmc_colorer_tpu_torch.models.vff import VFFColorer

    return VFFColorer(graph.port_graph(), layout=config["layout"], device=device)


def run(colorer, seed: int, repetition: int) -> dict:
    r = colorer.run(seed, repetition)
    return {"colors": r.colors, "n_colors": r.n_colors, "conflicts": 0,
            "rounds": r.iterations, "run_s": r.duration_ms / 1e3}


def graph_state(colorer):
    return "ell", colorer.ell.neighbors


neighbor_of = faults.ell_neighbor


# VFF's first phase is GreedyFF's segment, which the fault reaches too
FAULTS = {"skip_losers": faults.skip_losers}
CONTROLS = ("skip_losers",)
