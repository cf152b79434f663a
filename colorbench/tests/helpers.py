"""Small versions of the benchmark's cells for runs on the CPU."""

import dataclasses
import time

import torch

from colorbench import spec
from colorbench.run import execute

# at these sizes sound runs' largest balance index reads 6.5-7.5 and the
# skip_chain fault's ~20 (CPU, seeds 5, 21, 31, 41), so the tiny limit is 12
TINY = {"er100k_p01": {"n": 600, "p": 0.05},
        "er50k_p001": {"n": 800, "p": 0.02, "balance_limit": {"1": 12.0}}}


def tiny_cell(name: str) -> spec.Cell:
    c = spec.cell(name)
    return dataclasses.replace(c, config={**c.config, **TINY[c.config["name"]]})


def dry_run(name: str, seed: int = 5, seconds: float = 0.3, trace: bool = False):
    return execute(tiny_cell(name), seed, seconds, trace, torch.device("cpu"),
                   t_start=time.perf_counter())
