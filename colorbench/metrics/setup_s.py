"""Seconds from the start of the process to the start of the window:
loading, building or loading the kernels, the graph, warming every job."""

SOURCE, UNIT, LAYER, MOVES = "host_clock", "s", None, None


def read(run):
    return run.setup_s
