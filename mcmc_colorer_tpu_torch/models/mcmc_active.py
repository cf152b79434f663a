"""Frontier (active-set) capacity ladder.

Counterpart of ``_buckets`` and ``pick_cap`` in
``mcmc_colorer_tpu/models/mcmc_active.py``.  A frontier round gathers the
rows of at most ``cap`` vertices; ``cap`` is the smallest rung of the
ladder that holds the frontier, so the gathered band shrinks with it.
The port's frontier colorers (``greedy_ff``, ``vff``, ``luby`` with
``active=True``) use the ladder with the CPU/GPU ``bucket_factor`` of 4.

``ActiveMCMCColorer``, the frontier MCMC chain, is not ported yet
(ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

from torch.profiler import record_function

DEFAULT_BUCKET_FACTOR = 4


def _buckets(n_pad: int, min_bucket: int = 128, factor: int = DEFAULT_BUCKET_FACTOR) -> list[int]:
    """Frontier-capacity ladder: multiples of 128 from ``min_bucket``
    growing by ``factor`` (at least 2), closed by ``n_pad``."""
    out = []
    b = max(128, ((min_bucket + 127) // 128) * 128)
    factor = max(2, factor)
    while b < n_pad:
        out.append(b)
        b *= factor
    out.append(n_pad)
    return out


def pick_cap(caps: list[int], count: int) -> int:
    """Smallest ladder capacity holding ``count`` frontier vertices."""
    return next(c for c in caps if c >= max(count, 1))


def round_range(loop: str, cap: int):
    """A profiler range around one frontier round, named by its loop and
    its cap (``measure_kernels.py --colorers`` groups the rounds by the
    name); without a profiler it records nothing."""
    return record_function(f"{loop} round cap={cap}")
