"""The card's share of the port's graph set-up: the device's busy time
(merged intervals of the profiler's trace) in the traced set-up section
that builds the cell's fixed graph and its colourers (``loop.py``), the
same calls that ``setup.graph_s`` times on the host clock.  The warm jobs
lie outside the section."""

from colorbench.metrics_common import setup_busy_s

SOURCE, UNIT = "device_trace", "s"
LAYER = "graph set-up (ops/hashgen.py, graph/container.py, ops/ell_build.py)"
MOVES = "setup_s"


def read(run):
    return setup_busy_s(run)
