"""Arithmetic that several metric readers share.  A quantity that cells
of different end-to-end metrics report has one reader a population, and
they all read it here."""

import math

from colorbench.stats import p95_with_failures, rate
from colorbench.trace import SETUP_GRAPH, WINDOW


def valid_rate(run):
    """Valid colourings completed in the window over all its seconds."""
    return rate(sum(1 for j in run.jobs if j.seconds is not None), run.window_s)


def p95_ms(run):
    """The 95th percentile of every job's time, a failed job counted as
    missing any limit (None where that leaves it infinite)."""
    if not run.jobs:
        return None
    v = p95_with_failures([j.seconds for j in run.jobs]) * 1e3
    return v if math.isfinite(v) else None


def tailcut_ms(run):
    """Mean ``tailcut_seconds`` a job: the tailcut, the final count and
    the colours to the host."""
    xs = [j.result["tailcut_s"] for j in run.jobs if "tailcut_s" in j.result]
    return 1e3 * sum(xs) / len(xs) if xs else None


def idle_pct(run):
    """The share of the traced window in which no operation ran on the
    card, from the merged device intervals of the profiler's trace."""
    t = run.trace
    if t is None or not t.window_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def ms_per_sweep(run):
    jobs = [j for j in run.jobs if "sweeps" in j.result]
    sweeps = sum(j.result["sweeps"] for j in jobs)
    return 1e3 * sum(j.result["chain_s"] for j in jobs) / sweeps if sweeps else None


def _roofline_pct(run, trace, kernel: str, section: str):
    if trace is None or run.recorder is None or kernel not in run.recorder.kernels:
        return None
    launches, bound = run.recorder.bound_s(kernel, section)
    device = trace.kernel_s.get(kernel, 0.0)
    if not launches or device <= 0:
        return None
    return 100.0 * bound / device


def roofline_pct(run, kernel: str):
    """A kernel's share of its roofline over the window: None where the
    window ran no launch of it or the trace saw no device time of it
    (never 0)."""
    return _roofline_pct(run, run.trace, kernel, WINDOW)


def setup_roofline_pct(run, kernel: str):
    """A kernel's share of its roofline while set-up builds the fixed
    graph (the traced set-up section), None as ``roofline_pct``."""
    return _roofline_pct(run, run.setup_trace, kernel, SETUP_GRAPH)


def setup_busy_s(run):
    """The device's busy seconds, merged intervals, in the traced set-up
    section that builds the fixed graph and its colourers; None where the
    run has no such section or the trace saw no device work in it."""
    t = run.setup_trace
    return t.busy_s if t is not None and t.busy_s else None
