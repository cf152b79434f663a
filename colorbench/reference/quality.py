"""Validity and balance of a colouring, judged against a reference graph.

``balance_index`` is a frozen copy of the reference's formula
(MCMC_Colorer ``coloringMCMC_prints.cu:148-168``, as quoted in
``mcmc_colorer_tpu_torch/analysis/log_parser.py:183-189``): the mean class
size is n / nCol over the whole palette, and the squares are summed over
the used colours only,

    BI = sqrt( sum_{c used} (count_c - n / nCol)^2 / (n * p) ).
"""

from __future__ import annotations

import numpy as np
import torch


def balance_index(colors: np.ndarray, n_colors: int, p: float) -> float:
    n = colors.shape[0]
    h = np.bincount(colors.astype(np.int64), minlength=n_colors).astype(np.float64)
    used = h > 0
    return float(np.sqrt(((h[used] - n / n_colors) ** 2).sum() / (n * p)))


def balance_floor(n: int, p: float) -> float:
    """The smallest index above 0 that whole class sizes can give: one
    class one above an integer mean and another one below."""
    return float(np.sqrt(2.0 / (n * p)))


def palette(colorer: str, max_degree: int, num_col_ratio: float = 1.0) -> int:
    """The colours a colourer may use on a graph of this max degree: the
    chain's nCol = max degree / numColRatio (MCMC_Colorer main.cu:53,162),
    first fit's max degree + 1."""
    if colorer == "mcmc":
        return max(1, int(max_degree / num_col_ratio))
    return max_degree + 1


def off_palette(colors: np.ndarray, n_colors: int) -> int:
    """Vertices whose colour lies outside [0, n_colors)."""
    return int(((colors < 0) | (colors >= n_colors)).sum())


def conflict_edges(colors: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   chunk: int = 1 << 25) -> int:
    """Edges whose two ends share a colour."""
    total = 0
    for k in range(0, src.numel(), chunk):
        s, d = src[k:k + chunk].long(), dst[k:k + chunk].long()
        total += int((colors[s] == colors[d]).sum())
    return total
