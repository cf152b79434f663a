"""Kernel K3 (``csrc/first_fit.cu``): the first free allowed colour of
each ELL row.  Frozen copy of ``chip_smoke.py``'s count (``:548``,
``:1624-1625``, with chains ``:2021-2022``; ``_gathered_bytes`` at
``:246-251``):

- bytes: the ids and ``allow`` read once; for each chain the colours the
  real ids name (each once, no more than the real slots), its ``cur``
  where given, and the answer written (4 a row);
- operations: one a real neighbour slot for each chain, at the int32
  rate.
"""

import torch

from colorbench.peaks import INT32_OPS_PER_S

KERNEL = "first_fit_kernel"
WRAPS = ("mcmc_colorer_tpu_torch.ops.firstfit", "first_fit_cuda")
OPS_PER_S = INT32_OPS_PER_S


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def work(args, kwargs, memo):
    neigh, colors, allow = args[:3]
    cur = args[4] if len(args) > 4 else kwargs.get("cur")
    rows = neigh.shape[0]
    chains = colors.shape[0] if colors.dim() == 2 else 1
    n_ids = colors.shape[-1]
    slots = memo.get(neigh, ("slots", n_ids), lambda: (neigh < n_ids).sum())
    gathered = torch.clamp(slots, max=n_ids) * colors.element_size()
    n_bytes = _nbytes(neigh, allow, cur) + chains * (rows * 4 + gathered)
    return n_bytes, chains * slots
