"""CUDA launches, copies and sets of the hash graph's generation: those
whose host start lies inside an ``mc.hashgen`` span, over the
``mc.hashgen`` spans, in the profiled replay of the window's first jobs
(``colorbench/spans.py``).  The same for every run of one commit: it
does not move with the host's speed."""

from colorbench import spans

SOURCE, UNIT = "device_trace", "launches"
LAYER = "hash graph (ops/hashgen.py)"
MOVES = "colorings_per_s"


def read(run):
    return spans.per(run, lambda s: s.launches("mc.hashgen"), ["mc.hashgen"], device=True)
