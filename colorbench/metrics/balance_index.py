"""Geometric mean, over the window's valid colourings, of the reference's
balance index (``reference/quality.py``), an index of exactly 0 counted
as ``quality.balance_floor``."""

from colorbench.reference.quality import balance_floor, balance_index
from colorbench.stats import geomean

SOURCE, UNIT, LAYER, MOVES = "host_clock", "1", None, None


def read(run):
    n, p = run.config["n"], run.config["p"]
    vals = [balance_index(j.result["colors"], j.result["n_colors"], p)
            for j in run.jobs if j.seconds is not None]
    return geomean(vals, balance_floor(n, p)) if vals else None
