"""CUDA launches, copies and sets of the resident chain's proposal over
NC: those whose host start lies inside an ``mc.sweep.propose`` span,
over the chain bodies (``mc.body``), in the profiled replay of the
window's first jobs (``colorbench/spans.py``).  The same for every run of
one commit: it does not move with the host's speed."""

from colorbench import spans

SOURCE, UNIT = "device_trace", "launches"
LAYER = "chain, resident (models/mcmc_resident.py, models/mcmc.py)"
MOVES = "colorings_per_s"


def read(run):
    if run.config["path"] != "resident":
        return None
    return spans.per(run, lambda s: s.launches("mc.sweep.propose"), ["mc.body"], device=True)
