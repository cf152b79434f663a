"""PyTorch/CUDA port of ``mcmc_colorer_tpu`` for NVIDIA Hopper (H100).

Mirrors the JAX package's module paths and names so that each function
has an obvious counterpart.  The JAX package is the reference; this
package imports ``torch`` and never ``jax``.

Covered so far:

- slice 1, the resident path: ``config``, ``utils.rng``,
  ``ops.dense_adj`` (packed part), ``ops.packed_nc`` (kernel K1, CUDA C++
  in ``csrc/packed_nc.cu``), ``ops.hashgen``, ``models.mcmc`` (chain
  core), ``models.mcmc_resident``, ``graph.native``, ``interop``;
- slice 2, the ELL path: ``graph.container`` (``Graph``, flat ``to_ell``,
  ``EllGraph``), ``graph.generate``, ``graph.io``, ``ops.ell_build``,
  ``ops.neighbor``, ``ops.resample`` (kernel K2, ``csrc/resample.cu``),
  ``ops.firstfit`` (kernel K3, ``csrc/first_fit.cu``), ``models.mcmc``
  (the gather chain, the flat tailcut, ``MCMCColorer``),
  ``models.greedy_ff`` and ``models.base``.

Entry points::

    from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer
    coloring = ResidentMCMCColorer(n, p, graph_seed, params, device="cuda").run(seed)

    from mcmc_colorer_tpu_torch.graph.generate import erdos_renyi
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
    from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer
    g = erdos_renyi(n, p, seed)          # or graph.io.load_edge_list(path)
    coloring = MCMCColorer(g, params, backend="pallas", device="cuda").run(seed)
    coloring = GreedyFFColorer(g, device="cuda").run()
"""
