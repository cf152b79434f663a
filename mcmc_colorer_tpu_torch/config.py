"""Runtime configuration of the MCMC colorer.

Counterpart of ``mcmc_colorer_tpu/config.py`` (``ColorerKind``,
``ProposalKind``, ``InitKind``, ``MCMCParams``, ``default_n_colors``),
copied because importing anything under ``mcmc_colorer_tpu`` pulls in
jax.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass


class ColorerKind(str, enum.Enum):
    """Algorithm selection: the reference's five CLI colorers
    (README.md:111-115) plus the sequential greedy (colorer.cpp:135-208)."""

    MCMC = "mcmc"            # fully-parallel MCMC balanced colorer (--mcmcgpu)
    MCMC_SEQ = "mcmc_seq"    # sequential-semantics MCMC (--mcmccpu)
    LUBY = "luby"            # Luby-inspired greedy MIS colorer (--lubygpu)
    GREEDY_FF = "greedy_ff"  # Greedy First-Fit (--grdffgpu)
    VFF = "vff"              # Greedy FF + vertex-centric rebalancing (--vffgpu)
    GREEDY_SEQ = "greedy_seq"  # sequential degree-sorted first-fit


class ProposalKind(str, enum.Enum):
    """MCMC proposal-distribution variant (reference coloringMCMC.h:34-39)."""

    STANDARD = "standard"
    DECREASE_LINE = "decrease_line"
    DECREASE_EXP = "decrease_exp"
    BALANCE_LINE = "balance_line"
    BALANCE_EXP = "balance_exp"
    BALANCE_DYNAMIC = "balance_dynamic"


class InitKind(str, enum.Enum):
    """Initial-coloring distribution (coloringMCMC.h:27-29)."""

    UNIFORM = "uniform"
    DISTRIBUTION_LINE = "line"
    DISTRIBUTION_EXP = "exp"


@dataclass(frozen=True)
class MCMCParams:
    """Parameters of the MCMC balanced colorer, with the reference's
    hard-coded values (main.cu:160-168) as defaults."""

    n_colors: int
    max_iterations: int = 250
    epsilon: float = 1e-8
    lambda_: float = 1.0               # Hastings temperature / line-exp slope
    ratio_freezed: float = 1e-2        # kept for parity; unused
    taboo_iterations: int = 0
    tailcut: bool = False
    proposal: ProposalKind = ProposalKind.BALANCE_DYNAMIC
    init: InitKind = InitKind.UNIFORM
    seq_stall_escape: bool = False     # sequential colorer's tailcut only
    hastings: bool = False
    count_edges: bool = True

    def tailcut_threshold(self, n_nodes: int) -> int:
        """z = max(50, n/2000) when tailcut is enabled, else 0
        (reference coloringMCMC_CPU.cpp:89-97)."""
        if not self.tailcut:
            return 0
        return max(50, n_nodes // 2000)

    def replace(self, **kw) -> "MCMCParams":
        return dataclasses.replace(self, **kw)


def default_n_colors(max_degree: int, num_color_ratio: float = 1.0) -> int:
    """nCol default = maxDeg / numColRatio (reference main.cu:53,162)."""
    return max(1, int(max_degree / num_color_ratio))
