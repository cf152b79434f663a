"""The 95th percentile of the time to a valid colouring over every job of
the window, a failed job counted as missing any limit (resident path)."""

from colorbench.metrics_common import p95_ms

SOURCE, UNIT, LAYER, MOVES = "host_clock", "ms", None, None


def read(run):
    return p95_ms(run)
