"""CUDA launches, copies and sets a greedy round issues: those inside the
``mc.greedy.round`` (GreedyFF, and VFF's first phase) and ``mc.vff.round``
spans, over those rounds, in the profiled replay of the window's first
jobs (``colorbench/spans.py``)."""

from colorbench import spans

SOURCE, UNIT = "device_trace", "launches"
LAYER = "greedy colourers (models/greedy_ff.py, models/vff.py)"
MOVES = "colorings_per_s.ell"
ROUNDS = ["mc.greedy.round", "mc.vff.round"]


def read(run):
    return spans.per(run, lambda s: sum(s.launches(r) for r in ROUNDS), ROUNDS, device=True)
