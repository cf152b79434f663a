"""VFF's colouring is deterministic: the reference's (``greedy.py``)."""

from colorbench.reference.greedy import vff as expected  # noqa: F401
