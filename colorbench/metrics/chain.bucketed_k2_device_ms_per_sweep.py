"""K2's device time a sweep on the degree-bucketed layout: the device
intervals of the launches whose host start lies inside an
``mc.sweep.class`` span (one around each K2 call, once a degree class a
sweep: its launch and the sum of its rows' conflict counts), over the
``mc.body`` spans, in the profiled replay of the window's first jobs
(``colorbench/spans.py``).  None where the program has no such span."""

from colorbench import spans

SOURCE, UNIT = "device_trace", "ms"
LAYER = "chain, bucketed ELL (models/mcmc.py:_ell_sweep)"
MOVES = "colorings_per_s.ell"


def read(run):
    if run.config["path"] != "bucketed":
        return None
    s = spans.of(run)
    if s is None or not s.count("mc.sweep.class"):
        return None
    return spans.per(run, lambda s: s.device_ns("mc.sweep.class") / 1e6, ["mc.body"],
                     device=True)
