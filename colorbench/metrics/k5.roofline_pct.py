"""K5's share of its roofline while set-up builds the fixed graph: the
least time its launches' work needs (``roofline/k5.py``, each launch
recorded by the benchmark's own wrapper in the set-up section) over its
device time in that section's trace."""

from colorbench.metrics_common import setup_roofline_pct

SOURCE, UNIT = "device_trace", "%"
LAYER = "graph set-up, hash ELL (ops/hash_ell.py, csrc/hash_ell.cu)"
MOVES = "setup_s"


def read(run):
    return setup_roofline_pct(run, "k5")
