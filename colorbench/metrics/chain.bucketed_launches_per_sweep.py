"""CUDA launches, copies and sets a chain body issues on the
degree-bucketed layout: those whose host start lies inside an ``mc.body``
span, over the bodies, in the profiled replay of the window's first jobs
(``colorbench/spans.py``): a K2 launch a degree class and the body's
fixed launches.  The same for every run of one commit."""

from colorbench import spans

SOURCE, UNIT = "device_trace", "launches"
LAYER = "chain, bucketed ELL (models/mcmc.py:_ell_sweep)"
MOVES = "colorings_per_s.ell"


def read(run):
    if run.config["path"] != "bucketed":
        return None
    return spans.per(run, lambda s: s.launches("mc.body"), ["mc.body"], device=True)
