"""Valid colourings completed in the window, over all its seconds, in the
cells whose jobs the host's loop of small launches sets (the ELL path):
their runs spread with the host, so they have a bound of their own."""

from colorbench.metrics_common import valid_rate

SOURCE, UNIT, LAYER, MOVES = "host_clock", "colorings/s", None, None


def read(run):
    return valid_rate(run)
