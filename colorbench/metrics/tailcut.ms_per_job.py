"""Mean time after the chain a job on the resident path: the NC tailcut,
the final count and the colours to the host (``tailcut_seconds``)."""

from colorbench.metrics_common import tailcut_ms

SOURCE, UNIT, LAYER, MOVES = "program_span", "ms", "tailcut, resident (models/mcmc_resident.py:_tailcut_nc)", "colorings_per_s"


def read(run):
    return tailcut_ms(run)
