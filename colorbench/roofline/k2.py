"""Kernel K2 (``csrc/resample.cu``): one resampling sweep over ELL rows.
Frozen copy of ``chip_smoke.py:_k2_bytes_ops`` (``:577-590``),
``_gathered_bytes`` (``:246-251``) and its chain rule (``:1989-1990``):

- bytes: the ids read once (once for all chains); for each chain its
  row vectors (cur, taboo, unif), the colours the real ids name (each
  once, no more than the real slots), p_eff (4 x nCol), star, qstar,
  new_taboo and the conflicts written (12 a row) and 8 more; the own ids
  where given;
- operations: a compare a slot and a CDF step a colour, for each row and
  chain, at the float32 rate.
"""

import torch

from colorbench.peaks import FP32_OPS_PER_S

KERNEL = "resample_kernel"
WRAPS = ("mcmc_colorer_tpu_torch.ops.resample", "resample_sweep_cuda")
OPS_PER_S = FP32_OPS_PER_S


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def work(args, kwargs, memo):
    neigh, colors, cur, taboo, _row0, unif, _p_eff, _eps, params = args[:9]
    self_ids = args[9] if len(args) > 9 else kwargs.get("self_ids")
    rows, d_pad = neigh.shape
    chains = colors.shape[0] if colors.dim() == 2 else 1
    n_ids = colors.shape[-1]
    slots = memo.get(neigh, ("slots", n_ids), lambda: (neigh < n_ids).sum())
    gathered = torch.clamp(slots, max=n_ids) * colors.element_size()
    n_colors = params.n_colors
    n_bytes = (_nbytes(neigh, cur, taboo, unif, self_ids)
               + chains * (gathered + 4 * n_colors + rows * 12 + 8))
    return n_bytes, chains * rows * (d_pad + n_colors)
