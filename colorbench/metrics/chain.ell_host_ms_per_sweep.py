"""The host's own time of an ELL chain body: each ``mc.body`` span less
its ``mc.body.read`` (the conflict counts' host read, which waits for the
card), summed and over the bodies, in the profiled replay of the window's
first jobs (``colorbench/spans.py``)."""

from colorbench import spans

SOURCE, UNIT = "program_span", "ms"
LAYER = "chain, ELL (models/mcmc.py:MCMCColorer)"
MOVES = "colorings_per_s.ell"


def read(run):
    if run.config["path"] != "ell":
        return None
    return spans.per(run, lambda s: (s.total_ns("mc.body") - s.total_ns("mc.body.read")) / 1e6,
                     ["mc.body"])
