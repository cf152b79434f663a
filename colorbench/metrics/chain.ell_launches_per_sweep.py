"""CUDA launches, copies and sets a chain body issues on the ELL path:
those whose host start lies inside an ``mc.body`` span, over the bodies,
in the profiled replay of the window's first jobs (``colorbench/spans.py``).
The same for every run of one commit: it does not move with the host's
speed."""

from colorbench import spans

SOURCE, UNIT = "device_trace", "launches"
LAYER = "chain, ELL (models/mcmc.py:MCMCColorer)"
MOVES = "colorings_per_s.ell"


def read(run):
    if run.config["path"] != "ell":
        return None
    return spans.per(run, lambda s: s.launches("mc.body"), ["mc.body"], device=True)
