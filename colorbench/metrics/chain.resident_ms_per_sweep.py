"""Chain seconds over sweeps, summed over the window's jobs, on the
resident path (``Coloring.extra``: ``chain_seconds``, ``sweeps``)."""

from colorbench.metrics_common import ms_per_sweep

SOURCE, UNIT = "program_span", "ms"
LAYER = "chain, resident (models/mcmc_resident.py, models/mcmc.py)"
MOVES = "colorings_per_s"


def read(run):
    return ms_per_sweep(run) if run.config["path"] == "resident" else None
