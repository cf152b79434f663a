"""The program's spans (the ``mc.*`` ranges of
``mcmc_colorer_tpu_torch/utils/spans.py``) in a traced run.

The window's trace (``trace.py:Trace``) keeps its summary and no events,
so the readers of spans read a replay of the window's first jobs under a
kineto session of their own, after the window: the same colourers built
anew on the same graphs, each job with the window job's chain seed and
repetition (the same work), in whole rounds of the traffic's kinds, for
at least ``REPLAY_S`` seconds.  Nothing of the replay is judged or
counted among the window's jobs.

From the replay's events the module keeps arrays, not Python objects an
event:

- each span's name, host start and end;
- each launch (``is_launch``: the CUDA runtime's kernel launches and
  asynchronous copies and sets), its host start and correlation id;
- each device interval (kernel, copy, set), its correlation id and
  length.

A launch belongs to a span where its host start lies inside it (the
program drives the card from one host thread); its device time is that
of the intervals with its correlation id.  Where the program has no
spans (``utils/spans.py`` absent) there is no replay and every reader
returns None.
"""

from __future__ import annotations

import importlib.util
import sys
import time
from dataclasses import dataclass

import numpy as np

from colorbench import seeds, spec, stats, trace

REPLAY_S = 2.0
PREFIX = "mc."
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")
LAUNCH_NAMES = ("cudaMemcpyAsync", "cudaMemsetAsync")
_CACHE = "_program_spans"


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCH_PREFIXES) or name in LAUNCH_NAMES


def _on_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


@dataclass
class Spans:
    """The spans, launches and device intervals of one profiled stretch."""

    names: np.ndarray        # [spans] object: each span's name
    start: np.ndarray        # [spans] int64 ns
    end: np.ndarray          # [spans] int64 ns
    launch_start: np.ndarray  # [launches] int64 ns, sorted
    launch_corr: np.ndarray  # [launches] int64, in launch_start's order
    device_corr: np.ndarray  # [intervals] int64
    device_len: np.ndarray   # [intervals] int64 ns
    device_start: np.ndarray  # [intervals] int64
    host: tuple = ()         # (start, end, name) arrays of every host range, for naming gaps
    jobs: list = ()          # the replayed jobs' results

    @classmethod
    def from_events(cls, events, jobs=()) -> "Spans":
        names, s0, s1 = [], [], []
        hs, he, hn = [], [], []
        ls, lc = [], []
        dc, dn, ds = [], [], []
        for e in events:
            name = e.name()
            t, d = e.start_ns(), e.duration_ns()
            if _on_device(e):
                if not trace._annotation(e):  # the spans themselves leave no such row
                    dc.append(e.correlation_id())
                    dn.append(d)
                    ds.append(t)
                continue
            hs.append(t)
            he.append(t + d)
            hn.append(name)
            if name.startswith(PREFIX):
                names.append(name)
                s0.append(t)
                s1.append(t + d)
            elif is_launch(name):
                ls.append(t)
                lc.append(e.correlation_id())
        order = np.argsort(np.asarray(ls, dtype=np.int64), kind="stable")
        i64 = lambda x: np.asarray(x, dtype=np.int64)  # noqa: E731
        return cls(np.asarray(names, dtype=object), i64(s0), i64(s1),
                   i64(ls)[order], i64(lc)[order], i64(dc), i64(dn), i64(ds),
                   (i64(hs), i64(he), np.asarray(hn, dtype=object)), list(jobs))

    def _of(self, name: str) -> np.ndarray:
        return np.flatnonzero(self.names == name)

    def count(self, name: str) -> int:
        return int(self._of(name).size)

    def total_ns(self, name: str) -> int:
        k = self._of(name)
        return int((self.end[k] - self.start[k]).sum())

    def _launches_in(self, name: str) -> np.ndarray:
        """Indices of the launches whose host start lies inside a span of
        ``name`` (spans of one name do not overlap on one thread)."""
        k = self._of(name)
        lo = np.searchsorted(self.launch_start, self.start[k], side="left")
        hi = np.searchsorted(self.launch_start, self.end[k], side="right")
        return np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)] + [np.zeros(0, int)])

    def launches(self, name: str) -> int:
        return int(self._launches_in(name).size)

    def device_ns(self, name: str) -> int:
        """Summed device intervals started by the launches inside the
        spans of ``name``, linked by correlation id."""
        corr = self.launch_corr[self._launches_in(name)]
        return int(self.device_len[np.isin(self.device_corr, corr)].sum())

    def named_gaps(self, top: int = 10) -> list:
        """The longest stretches of the replay in which the device ran
        nothing, each named by the innermost span open over its middle and
        the innermost host range inside that: ``mc.body.p_eff > aten::ge``;
        outside spans by the innermost host range alone."""
        if not self.device_start.size or not self.host:
            return []
        hs, he, hn = self.host
        t0, t1 = int(hs.min()), int(he.max())
        busy = [(int(a), int(a + b)) for a, b in zip(self.device_start, self.device_len)]
        gaps = sorted(stats.gaps(busy, t0, t1), key=lambda g: g[0] - g[1])[:top]
        out = []
        for g0, g1 in gaps:
            out.append([gap_name((g0 + g1) / 2, hs, he, hn), (g1 - g0) / 1e9])
        return out


def gap_name(mid: float, hs, he, hn) -> str:
    """The innermost ``mc.*`` span open at ``mid``, then the innermost host
    range open there, if another; outside spans the innermost host range."""
    hit = np.flatnonzero((hs <= mid) & (he >= mid))
    if not hit.size:
        return "no host range"
    inner = hit[np.argmax(hs[hit])]
    ours = [k for k in hit if str(hn[k]).startswith(PREFIX)]
    if not ours:
        return str(hn[inner])[:160]
    span = max(ours, key=lambda k: hs[k])
    if span == inner:
        return str(hn[span])[:160]
    return f"{hn[span]} > {hn[inner]}"[:160]


def program_has_spans() -> bool:
    return importlib.util.find_spec("mcmc_colorer_tpu_torch.utils.spans") is not None


def of(run):
    """The replay's ``Spans`` of a traced run (made once a run), or None
    where the run was not traced or the program has no spans."""
    if run.trace is None:
        return None
    if _CACHE not in run.__dict__:
        run.__dict__[_CACHE] = replay(run) if program_has_spans() else None
    return run.__dict__[_CACHE]


def replay(run) -> Spans:
    """The window's first jobs again under a kineto session: whole rounds
    of the traffic's kinds, until ``REPLAY_S`` seconds have passed."""
    from colorbench import loop

    config, device = run.config, run.device
    kinds = [(j, spec.driver(config["path"], j["colorer"])) for j in run.cell.traffic["jobs"]]
    per_job = run.cell.traffic["graph"] == "per_job"
    handles = []
    if not per_job:
        graph = run.graphs[config["graph_seed"]]
        handles = [d.make(config, j, graph, device) for j, d in kinds]
    chain = seeds.chain_seed(run.seed)
    results = []
    loop._sync(device)
    trace._start_profiler()
    t0 = time.perf_counter()
    try:
        for i, job in enumerate(run.jobs):
            if i % len(kinds) == 0 and time.perf_counter() - t0 >= REPLAY_S:
                break
            j, d = kinds[i % len(kinds)]
            h = d.make(config, j, run.graphs[job.graph_seed], device) if per_job else handles[
                i % len(kinds)]
            res = d.run(h, chain, i)
            results.append({k: v for k, v in res.items() if k != "colors"})
            del h
        loop._sync(device)
    finally:
        events = trace._stop_profiler()
    replay_s = time.perf_counter() - t0
    out = Spans.from_events(events, results)
    del events, handles
    _report(out, replay_s)
    return out


def _report(s: Spans, seconds: float) -> None:
    """What the replay saw, beside what its jobs report, on standard error."""
    sweeps = sum(r.get("sweeps", 0) for r in s.jobs)
    rounds = sum(r.get("rounds", 0) for r in s.jobs)
    tail = sum(1 for r in s.jobs if "tailcut_s" in r)
    print(f"spans: replayed {len(s.jobs)} jobs in {seconds:.3f} s; mc.body {s.count('mc.body')} "
          f"(jobs' sweeps {sweeps}); mc.greedy.round {s.count('mc.greedy.round')}, "
          f"mc.vff.round {s.count('mc.vff.round')} (jobs' rounds {rounds}); mc.tailcut "
          f"{s.count('mc.tailcut')} of {tail} jobs; mc.hashgen {s.count('mc.hashgen')}",
          file=sys.stderr)
    print(f"spans: idle gaps by span {s.named_gaps()}", file=sys.stderr)


def per(run, numerator, count_names, device: bool = False) -> float | None:
    """``numerator(spans)`` over the summed count of ``count_names``'
    spans; None where the replay holds none of them, or, with ``device``,
    where it saw no device work (a run on the CPU)."""
    s = of(run)
    if s is None or (device and not s.device_len.size):
        return None
    n = sum(s.count(c) for c in count_names)
    return numerator(s) / n if n else None
