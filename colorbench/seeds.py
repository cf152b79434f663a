"""Seeds of a run's graphs and jobs: pure functions of ``--seed`` and the
job's index, folded to the 32 bits the program's generators keep."""

from __future__ import annotations

import hashlib


def derive(seed: int, purpose: str, index: int = 0) -> int:
    """A 32-bit seed for (``seed``, ``purpose``, ``index``); any whole
    ``seed``, also one wider than 32 bits, gives a distinct stream."""
    digest = hashlib.blake2b(f"{seed}:{purpose}:{index}".encode(), digest_size=4).digest()
    return int.from_bytes(digest, "little")


def graph_seed(seed: int, job: int) -> int:
    """The graph of job ``job`` where every job has its own graph (a
    traffic that reuses one graph takes the configuration's)."""
    return derive(seed, "job-graph", job)


def chain_seed(seed: int) -> int:
    """The chain seed of a run; job j runs it at repetition j."""
    return derive(seed, "chain")


def warm_seed(seed: int) -> int:
    """The seed of the set-up's warm-up jobs, which no window job shares."""
    return derive(seed, "warm")


def sample_seed(seed: int) -> int:
    """The seed that draws the sample of jobs the reference checks."""
    return derive(seed, "sample")
