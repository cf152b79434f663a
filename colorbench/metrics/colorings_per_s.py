"""Valid colourings completed in the window, over all its seconds, in the
cells whose jobs the card's work sets (the resident path)."""

from colorbench.metrics_common import valid_rate

SOURCE, UNIT, LAYER, MOVES = "host_clock", "colorings/s", None, None


def read(run):
    return valid_rate(run)
