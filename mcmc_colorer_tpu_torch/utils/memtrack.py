"""Device-memory tracking (counterpart of GPUMemTracker, GPUutils.h:36-71,
and of ``mcmc_colorer_tpu/utils/memtrack.py``).

The numbers come from the CUDA caching allocator
(``torch.cuda.memory_stats``); ``measure_kernels.py --colorers`` reads
each colorer run's peak from them.
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
