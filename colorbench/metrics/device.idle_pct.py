"""The card's idle share of the traced window, in the resident cells."""

from colorbench.metrics_common import idle_pct

SOURCE, UNIT, LAYER, MOVES = "device_trace", "%", "device", "colorings_per_s"


def read(run):
    return idle_pct(run)
