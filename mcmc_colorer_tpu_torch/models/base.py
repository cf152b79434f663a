"""Colorer output type, validators and quality metrics.

Counterpart of ``mcmc_colorer_tpu/models/base.py``: ``Coloring`` with its
class statistics, ``check_coloring`` (host CSR), ``build_coloring`` and
the ELL-side ``count_conflict_edges`` / ``violating_nodes``; and what the
colorers share for ``layout="bucketed"`` (``bucketed_layout``,
``colors_in_input_order``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from mcmc_colorer_tpu_torch.graph.container import EllGraph, Graph

# edges per band of check_coloring: ~5 int64/bool temporaries of this
# length (~160 MB) instead of four 2m-long arrays
CHECK_BAND_EDGES = 1 << 22


def colorer_device(device="cuda") -> torch.device:
    """The device a colorer runs on.  ``"cuda"`` (the colorers' default)
    or ``None`` is the current CUDA device; without one this raises: a
    colorer runs on the CPU only when asked to (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"no CUDA device for device={str(dev)!r}: the colorers run on "
                "the card; pass device='cpu' to run their plain versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass
class Coloring:
    """Result of a colorer: ``colors[i]`` is the 0-based colour of node i;
    ``n_colors`` the palette size the run used; the rest is execution
    metadata."""

    colors: np.ndarray
    n_colors: int
    iterations: int = 0
    converged: bool = True
    duration_ms: float = 0.0
    conflict_trace: np.ndarray | None = None
    extra: dict = field(default_factory=dict)

    @cached_property
    def histogram(self) -> np.ndarray:
        return np.bincount(self.colors, minlength=self.n_colors)

    @cached_property
    def used_colors(self) -> int:
        return int((self.histogram > 0).sum())

    @cached_property
    def color_classes(self) -> tuple[np.ndarray, np.ndarray]:
        """(col_class, cumul_size): node ids sorted by colour, and the
        exclusive prefix of class sizes (length n_colors + 1)."""
        order = np.argsort(self.colors, kind="stable")
        cumul = np.zeros(self.n_colors + 1, dtype=np.int64)
        np.cumsum(self.histogram, out=cumul[1:])
        return order, cumul

    def class_stats(self) -> dict:
        """Mean / variance / std of class sizes over the full palette."""
        h = self.histogram.astype(np.float64)
        mean = h.sum() / self.n_colors
        var = float(((h - mean) ** 2).mean())
        return {"mean": float(mean), "variance": var, "std": float(np.sqrt(var))}

    def class_degree_stats(self, g: Graph) -> tuple[np.ndarray, np.ndarray]:
        """(mean_degree, std_degree) per colour class."""
        deg = g.degrees.astype(np.float64)
        sums = np.bincount(self.colors, weights=deg, minlength=self.n_colors)
        sqs = np.bincount(self.colors, weights=deg * deg, minlength=self.n_colors)
        cnt = np.maximum(self.histogram, 1)
        mean = sums / cnt
        var = np.maximum(sqs / cnt - mean**2, 0.0)
        return mean, np.sqrt(var)

    def ascii_histogram(self, width: int = 60) -> str:
        """ASCII class-size histogram ('every * is K nodes')."""
        h = self.histogram
        divider = max(1, int(h.max()) // max(width, 1))
        lines = [f"Color {i} " + "*" * (int(h[i]) // divider) for i in range(self.n_colors)]
        lines.append(f"Every * is {divider} nodes")
        return "\n".join(lines)

    def balance_index(self, prob: float) -> float:
        """sqrt(Σ_{used c} (count_c − n/nCol)² / (n·p)), summed over used
        colours only, as the reference does."""
        n = self.colors.shape[0]
        avg = n / self.n_colors
        h = self.histogram
        used = h > 0
        bi = float(((h[used] - avg) ** 2).sum())
        denom = n * prob if prob > 0 else n
        return float(np.sqrt(bi / denom))

    def efficiency_num_processors(self, n_processors: int) -> float:
        """E = mean over classes of (cs/P) / ceil(cs/P)."""
        h = self.histogram.astype(np.float64)
        nz = h > 0
        if not nz.any():
            return 0.0
        cs = h[nz]
        eff = (cs / n_processors) / np.ceil(cs / n_processors)
        return float(eff.sum() / self.n_colors)


def check_coloring(g: Graph, colors: np.ndarray, allow_uncolored: bool = False) -> bool:
    """Validity check: no edge joins two same-coloured nodes.  Walks the
    CSR in row bands of about ``CHECK_BAND_EDGES`` stored edges, so the
    temporaries stay small at any m."""
    colors = np.asarray(colors)
    rp = g.row_ptr
    r0 = 0
    while r0 < g.n:
        r1 = int(np.searchsorted(rp, rp[r0] + CHECK_BAND_EDGES, side="right")) - 1
        r1 = min(max(r1, r0 + 1), g.n)
        e0, e1 = int(rp[r0]), int(rp[r1])
        own = np.repeat(colors[r0:r1], np.diff(rp[r0:r1 + 1]))
        same = own == colors[g.cols[e0:e1]]
        if allow_uncolored:
            same &= own >= 0
        if same.any():
            return False
        r0 = r1
    return True


def bucketed_layout(graph: Graph, *, descending: bool, min_lane: int, device):
    """(layout, perm, pos) of ``layout="bucketed"``: the graph relabelled by
    degree (``descending``: hubs first, the Welsh-Powell order the lower-id
    rules of GreedyFF, VFF and Luby favour), its ``BucketedEll`` with
    128-row classes on ``device``, ``perm[new id] = old id`` and each new
    id's padded position."""
    g2, perm = graph.degree_relabel(descending=descending)
    bell = g2.to_ell_bucketed(block=128, min_lane=min_lane, device=device)
    return bell, perm, bell.real_positions()


def colors_in_input_order(colors: torch.Tensor, n: int, perm=None, pos=None) -> np.ndarray:
    """A padded colour vector as the input graph's [n] colours: its first n
    entries on a flat layout, or read at the bucketed layout's positions
    ``pos`` and put back through the relabelling ``perm``."""
    if perm is None:
        return colors[:n].cpu().numpy()
    out = np.empty(n, dtype=np.int32)
    out[perm] = colors.cpu().numpy()[pos]
    return out


def build_coloring(g: Graph, colors: np.ndarray, n_colors: int, **meta) -> Coloring:
    """Package a raw colour array."""
    return Coloring(colors=np.asarray(colors), n_colors=n_colors, **meta)


def count_conflict_edges(ell: EllGraph, colors: torch.Tensor) -> torch.Tensor:
    """Number of conflicting edges, deduped by ``neighbor > self`` (0-dim
    int64).  One gather over the whole ELL; the chain counts in row bands
    (``models/mcmc.py:_conflict_edges``)."""
    from mcmc_colorer_tpu_torch.ops.neighbor import neighbor_colors

    colors = colors.to(torch.int32)
    ids = torch.arange(ell.n_pad, dtype=torch.int32, device=colors.device)[:, None]
    nc = neighbor_colors(ell.neighbors, colors)
    return ((nc == colors[:, None]) & (ell.neighbors > ids)).sum()


def violating_nodes(ell: EllGraph, colors: torch.Tensor) -> torch.Tensor:
    """(n_pad,) bool: the vertex has a neighbour of its own colour."""
    from mcmc_colorer_tpu_torch.ops.neighbor import neighbor_colors

    colors = colors.to(torch.int32)
    return (neighbor_colors(ell.neighbors, colors) == colors[:, None]).any(1)
