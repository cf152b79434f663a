"""Mean time after the chain a job on the ELL path: the K3 tailcut, the
final count and the colours to the host (``tailcut_seconds``)."""

from colorbench.metrics_common import tailcut_ms

SOURCE, UNIT, LAYER, MOVES = "program_span", "ms", "tailcut, ELL (models/mcmc.py:_tailcut)", "colorings_per_s.ell"


def read(run):
    return tailcut_ms(run)
