"""The tailcut's kernel time a round on the degree-bucketed layout: the
device intervals of the launches whose host start lies inside an
``mc.tailcut.class`` span (K3's tailcut call and the lower-movable call,
each once a degree class a round), over the ``mc.tailcut.round`` spans,
in the profiled replay of the window's first jobs
(``colorbench/spans.py``).  None where the program has no such span."""

from colorbench import spans

SOURCE, UNIT = "device_trace", "ms"
LAYER = "tailcut, bucketed ELL (models/mcmc.py:_tailcut_body)"
MOVES = "colorings_per_s.ell"


def read(run):
    if run.config["path"] != "bucketed":
        return None
    s = spans.of(run)
    if s is None or not s.count("mc.tailcut.class"):
        return None
    return spans.per(run, lambda s: s.device_ns("mc.tailcut.class") / 1e6,
                     ["mc.tailcut.round"], device=True)
