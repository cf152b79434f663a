"""GreedyFF's colouring is deterministic: the reference's (``greedy.py``)."""

from colorbench.reference.greedy import greedy_ff as expected  # noqa: F401
