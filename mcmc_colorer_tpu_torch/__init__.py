"""PyTorch/CUDA port of ``mcmc_colorer_tpu`` for NVIDIA Hopper (H100).

Mirrors the JAX package's module paths and names so that each function
has an obvious counterpart, and exports the same names.  The JAX package
is the reference; this package imports ``torch`` and never ``jax``.

Three hand-written CUDA C++ kernels for sm_90a carry the device work,
each replacing one Pallas kernel of the JAX package: K1, the neighbour
colour counts over a bit-packed adjacency (``ops/packed_nc.py``,
``csrc/packed_nc.cu``); K2, the resample sweep over an ELL
(``ops/resample.py``, ``csrc/resample.cu``); K3, the masked first fit
(``ops/firstfit.py``, ``csrc/first_fit.cu``).  On a CPU tensor each
wrapper runs its plain torch version; the colorers run on the current
CUDA device unless given ``device="cpu"``.

What is there:

- graphs: ``graph.container`` (``Graph``, flat and degree-bucketed
  ELL), ``graph.generate`` (ER, Barabási–Albert), ``graph.io`` (edge
  lists and the reference's converters), ``graph.native`` (the C++
  importer, samplers, hash-graph enumerator and sequential chain),
  ``ops.hashgen`` (the hash-defined ER graph built on the card);
- colorers: ``models.mcmc`` (``MCMCColorer``: K2, its plain version, or
  K1 over a packed A), ``models.mcmc_active`` (the frontier chain),
  ``models.mcmc_resident`` (the graph generated on the card, K1),
  ``models.chain_api`` (stepped chains and checkpoints),
  ``models.greedy_ff``, ``models.vff``, ``models.luby``, and the host
  colorers ``models.mcmc_sequential`` and ``models.greedy_seq``;
- ensembles: ``parallel.chains`` (``EnsembleMCMCColorer``, also over a
  mesh's chain groups), ``parallel.sharded`` (``ShardedMCMCColorer``:
  chains and vertex shards over ``parallel.mesh`` on
  ``torch.distributed``);
- the command line (``cli``), the baseline and validation scripts
  (``scripts``) and the offline analysis of run logs (``analysis``).

Entry points::

    from mcmc_colorer_tpu_torch import MCMCParams
    from mcmc_colorer_tpu_torch.graph.generate import erdos_renyi
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
    g = erdos_renyi(n, p, seed)          # or graph.io.load_edge_list(path)
    coloring = MCMCColorer(g, MCMCParams(n_colors=g.max_degree)).run(seed)

    from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer
    coloring = ResidentMCMCColorer(n, p, graph_seed, params).run(seed)
"""

from mcmc_colorer_tpu_torch.config import (
    ColorerKind,
    InitKind,
    MCMCParams,
    ProposalKind,
    RunConfig,
)
from mcmc_colorer_tpu_torch.graph.container import Graph
from mcmc_colorer_tpu_torch.models.base import Coloring

__version__ = "0.1.0"

__all__ = [
    "Graph",
    "Coloring",
    "MCMCParams",
    "RunConfig",
    "ColorerKind",
    "ProposalKind",
    "InitKind",
    "__version__",
]
