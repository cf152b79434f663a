"""The port's graph set-up in the run's set-up: the benchmark's clock,
ended by a synchronise, around building the program's graph and its
colourers (hash generation, or the host graph and its ELL on the card)."""

SOURCE, UNIT, LAYER, MOVES = "host_clock", "s", "graph set-up (ops/hashgen.py, graph/container.py, ops/ell_build.py)", "setup_s"


def read(run):
    return run.setup_graph_s
