"""CUDA launches, copies and sets a round of the ELL tailcut issues: those
whose host start lies inside an ``mc.tailcut.round`` span, over those
spans, in the profiled replay of the window's first jobs
(``colorbench/spans.py``).  None off the ELL paths: the resident NC
tailcut's rounds carry the same span name.  The same for every run of
one commit: it does not move with the host's speed."""

from colorbench import spans

SOURCE, UNIT = "device_trace", "launches"
LAYER = "tailcut, ELL (models/mcmc.py:_tailcut)"
MOVES = "colorings_per_s.ell"


def read(run):
    if run.config["path"] not in ("ell", "hash_ell"):
        return None
    return spans.per(run, lambda s: s.launches("mc.tailcut.round"), ["mc.tailcut.round"],
                     device=True)
