"""K4's share of its roofline over the window: the least time its
launches' inputs need (``roofline/k4.py``, each launch recorded by the
benchmark's own wrapper) over its device time in the profiler's trace."""

from colorbench.metrics_common import roofline_pct

SOURCE, UNIT, LAYER, MOVES = "device_trace", "%", "kernel K4 (csrc/propose_nc.cu)", "colorings_per_s"


def read(run):
    return roofline_pct(run, "k4")
