"""Chain seconds over sweeps, summed over the window's jobs, on the
degree-bucketed layout (``Coloring.extra``: ``chain_seconds``,
``sweeps``)."""

from colorbench.metrics_common import ms_per_sweep

SOURCE, UNIT = "program_span", "ms"
LAYER = "chain, bucketed ELL (models/mcmc.py:_ell_sweep)"
MOVES = "colorings_per_s.ell"


def read(run):
    return ms_per_sweep(run) if run.config["path"] == "bucketed" else None
