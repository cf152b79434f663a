"""PyTorch/CUDA port of ``mcmc_colorer_tpu`` for NVIDIA Hopper (H100).

Mirrors the JAX package's module paths and names so that each function
has an obvious counterpart.  The JAX package is the reference; this
package imports ``torch`` and never ``jax``.

Covered so far (slice 1, the resident main path): ``config``,
``utils.rng``, ``ops.dense_adj`` (packed part), ``ops.packed_nc``
(kernel K1, CUDA C++ in ``csrc/packed_nc.cu``), ``ops.hashgen``,
``ops.neighbor.color_histogram``, ``models.mcmc`` (chain core),
``models.mcmc_resident``, ``models.base``, ``graph.native``,
``graph.container`` and ``interop``.

Entry point::

    from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer
    coloring = ResidentMCMCColorer(n, p, graph_seed, params, device="cuda").run(seed)
"""
