"""Colour-class histogram (counterpart of ``ops/neighbor.py:color_histogram``)."""

from __future__ import annotations

import torch


def color_histogram(
    colors: torch.Tensor, n_colors: int, node_mask: torch.Tensor | None = None
) -> torch.Tensor:
    """[n_colors] int32 class sizes.  Colours outside the palette and
    vertices outside ``node_mask`` (phantom padding) are dropped."""
    keep = (colors >= 0) & (colors < n_colors)
    if node_mask is not None:
        keep &= node_mask
    return torch.bincount(colors[keep], minlength=n_colors).to(torch.int32)
