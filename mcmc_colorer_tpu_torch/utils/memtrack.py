"""Device-memory tracking (counterpart of GPUMemTracker, GPUutils.h:36-71,
and of ``mcmc_colorer_tpu/utils/memtrack.py``).

The numbers come from the CUDA caching allocator
(``torch.cuda.memory_stats``), the peak of a run among them.
``estimate_run_bytes`` is JAX's
analytic footprint of a chain run, kept as its counterpart (its formula
is JAX's, not fitted to the port).
"""

from __future__ import annotations

import torch


def device_memory_stats(device=None) -> dict:
    """Bytes in use, peak and the card's total memory for a CUDA device
    (the current one by default); an empty dict for a CPU device or
    without CUDA."""
    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }


def estimate_run_bytes(
    n_nodes: int,
    max_degree: int,
    n_colors: int,
    block: int = 256,
    n_chains: int = 1,
) -> dict:
    """JAX's analytic footprint of one MCMC chain run, in bytes, and what
    each key counts on the card:

    - ``ell_bytes``: the int32 neighbour ids, n × max degree;
    - ``gather_bytes``: as many gathered neighbour colours (K2 looks the
      colours up itself, so the port holds no such array: an upper count);
    - ``vector_bytes``: five int32 vectors of n a chain (colours, star,
      taboo, uniforms, flags);
    - ``kernel_block_bytes``: one row block's working set, block × nCol ×
      five int32 (a block's share of the work, not an on-chip memory);
    - ``total_bytes``: (ell + gather + vectors) a chain, plus one block;
    - ``reference_colors_checker_bytes``: the reference's n × nCol bool
      colorsChecker (coloringMCMC_main.cu:39), which neither package
      allocates."""
    ints = 4
    ell = n_nodes * max_degree * ints
    nc = n_nodes * max_degree * ints
    vectors = 5 * n_nodes * ints
    block_occ = block * n_colors * 5 * ints
    return {
        "ell_bytes": ell,
        "gather_bytes": nc,
        "vector_bytes": vectors * n_chains,
        "kernel_block_bytes": block_occ,
        "total_bytes": (ell + nc + vectors) * n_chains + block_occ,
        "reference_colors_checker_bytes": n_nodes * n_colors,
    }
