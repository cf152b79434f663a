"""Small versions of the benchmark's cells for runs on the CPU.

Each configuration's tiny size is a file of its own,
``tiny/<config>.json``: ``config``, the keys that override the
configuration on the CPU; ``skip_chain_fails``, the numbers the judge
must find over their limits when the chain is left at its start (for the
cells whose drivers can have the ``skip_chain`` fault); and ``why``.
"""

import dataclasses
import json
import time
from pathlib import Path

import torch

from colorbench import spec
from colorbench.run import execute

TINY_DIR = Path(__file__).resolve().parent / "tiny"


def tiny_path(config: str) -> Path:
    return TINY_DIR / f"{config}.json"


def tiny(config: str) -> dict:
    """The tiny size of a configuration, from its file."""
    path = tiny_path(config)
    if not path.is_file():
        raise FileNotFoundError(f"configuration {config!r} has no tiny size for the CPU "
                                f"tests: add {path}")
    return json.loads(path.read_text())


def tiny_cell(name: str) -> spec.Cell:
    c = spec.cell(name)
    return dataclasses.replace(c, config={**c.config, **tiny(c.config["name"])["config"]})


def dry_run(name: str, seed: int = 5, seconds: float = 0.3, trace: bool = False):
    return execute(tiny_cell(name), seed, seconds, trace, torch.device("cpu"),
                   t_start=time.perf_counter())


def ell_of_edges(src: torch.Tensor, dst: torch.Tensor, n: int, width: int | None = None,
                 seed: int = 0, chunk: int = 1 << 26) -> torch.Tensor:
    """An ELL [n, width] int32 of an undirected edge list, built on the
    edges' device: each row's neighbour ids in an order drawn from
    ``seed``, padded with n; ``width`` defaults to the max degree rounded
    up to 32.  Rows wider than ``width`` are cut (the judge counts them).
    A test's stand-in for the program's ELL, at any size the card holds."""
    dev = src.device
    g = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(2 * src.numel(), generator=g, device=dev)
    a = torch.cat([src, dst]).to(torch.int32)[perm]
    b = torch.cat([dst, src]).to(torch.int32)[perm]
    del perm
    a, order = torch.sort(a, stable=True)
    b = b[order]
    del order
    deg = torch.bincount(a, minlength=n)
    start = torch.cumsum(deg, 0) - deg
    if width is None:
        width = -(-int(deg.max()) // 32) * 32 if n else 0
    out = torch.full((n, width), n, dtype=torch.int32, device=dev)
    for k in range(0, a.numel(), chunk):
        ak = a[k:k + chunk].long()
        pos = torch.arange(k, k + ak.numel(), device=dev) - start[ak]
        keep = pos < width
        out[ak[keep], pos[keep]] = b[k:k + chunk][keep]
    return out
