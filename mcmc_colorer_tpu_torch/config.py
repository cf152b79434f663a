"""Runtime configuration of the MCMC colorer.

Counterpart of ``mcmc_colorer_tpu/config.py`` (``ColorerKind``,
``ProposalKind``, ``InitKind``, ``MCMCParams``, ``default_n_colors``,
``RunConfig``), copied because importing anything under
``mcmc_colorer_tpu`` pulls in jax.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import time
from dataclasses import dataclass, field


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


@dataclass
class RunConfig:
    """A whole run, as the reference's command line describes it
    (ArgHandle.cpp:31-58): the colorer, the graph (an edge-list file or
    a simulated ER(n, p)), the palette and the repetitions, with JAX's
    fields and defaults.  ``n_chains``, ``mesh_chains`` and
    ``mesh_shards`` are the ensemble's and the mesh's sizes;
    ``use_pallas`` picks kernel K2 for the sweep (``backend="pallas"``)
    over its plain torch version (``"xla"``)."""

    colorer: ColorerKind = ColorerKind.MCMC_SEQ  # the reference's default (ArgHandle.cpp:247-249)
    graph_path: str | None = None
    simulate_p: float | None = None
    n_nodes: int = 0
    n_colors: int = 0                   # 0: max degree / num_color_ratio
    num_color_ratio: float = 1.0        # clamped to [1, 16] (ArgHandle.cpp:148-156)
    taboo_iterations: int = 0
    tailcut: bool = False
    repetitions: int = 1
    seed: int = field(default_factory=lambda: int(time.time()))
    out_dir: str | None = None
    n_chains: int = 1
    mesh_chains: int = 1
    mesh_shards: int = 1
    use_pallas: bool = True
    proposal: ProposalKind = ProposalKind.BALANCE_DYNAMIC
    hastings: bool = False

    @property
    def graph_name(self) -> str:
        """The file's base name without its extension, or
        ``<n>_<p>_<ratio>`` for a simulated graph (ArgHandle.cpp:285-306)."""
        if self.graph_path is not None:
            base = os.path.basename(self.graph_path)
            return base.rsplit(".", 1)[0] if "." in base else base
        return f"{self.n_nodes}_{self.simulate_p}_{self.num_color_ratio}"

    @property
    def output_dir(self) -> str:
        return self.out_dir if self.out_dir else f"{self.graph_name}_out"

    def mcmc_params(self, max_degree: int) -> MCMCParams:
        """The chain's parameters; nCol = ``n_colors``, or max degree /
        numColRatio with the ratio clamped to [1, 16]."""
        ratio = min(16.0, max(1.0, float(self.num_color_ratio)))
        return MCMCParams(
            n_colors=self.n_colors or default_n_colors(max_degree, ratio),
            taboo_iterations=self.taboo_iterations,
            tailcut=self.tailcut,
            proposal=self.proposal,
            hastings=self.hastings,
        )
