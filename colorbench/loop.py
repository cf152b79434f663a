"""Set-up and the closed loop of one run.

A run builds what its traffic reuses (the graph, the colourers) and
warms every kind of job once, all counted as set-up; then it runs one
job at a time for ``seconds``, each started when the previous one has
handed its colours to the host.  A job's time runs from its start to its
colours on the host; a job that ends with conflicts is failed and has no
time.
"""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np

from colorbench import seeds, spec
from colorbench.trace import SETUP_GRAPH, SETUP_WARM, WINDOW


def make_graph(config: dict, seed: int):
    """The graph input of the configuration's family
    (``families/<family>.py``) for this graph seed."""
    return spec.family(config["family"]).make(config, seed)


@dataclass
class Job:
    index: int
    spec: dict
    graph_seed: int
    seconds: float | None      # None: failed
    result: dict


@dataclass
class Run:
    cell: spec.Cell
    seed: int
    device: object
    setup_s: float = 0.0
    setup_graph_s: float | None = None
    window_s: float = 0.0
    jobs: list[Job] = field(default_factory=list)
    graphs: dict = field(default_factory=dict)       # graph seed -> graph input
    graph_state: list = field(default_factory=list)  # (graph seed, kind, tensor)
    memory_peak_bytes: int = 0
    trace: object = None
    setup_trace: object = None  # the traced set-up section that builds the fixed graph
    recorder: object = None
    setup_phases: dict = field(default_factory=dict)  # phase -> seconds since start, at its end

    @property
    def config(self) -> dict:
        return self.cell.config


def _compact(colors) -> np.ndarray:
    """A job's colours as kept until the judge reads them: int16 where
    they fit (a long window holds thousands of colourings)."""
    c = np.asarray(colors)
    fits = c.size == 0 or (int(c.min()) >= -32768 and int(c.max()) < 32768)
    return c.astype(np.int16 if fits else np.int32)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_kernels(kernels) -> None:
    """Build (first run in a checkout) or load the program's kernel
    libraries, in parallel, so that none builds inside the window."""
    import importlib

    mods = [importlib.import_module(spec.roofline(k).WRAPS[0]) for k in sorted(set(kernels))]
    errors: list[BaseException] = []

    def load(m):
        try:
            m.load_kernel()
        except BaseException as e:  # re-raised below, in the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=load, args=(m,)) for m in mods]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def _range(profile, name: str):
    """A named host range in the profiler's trace, where a profiler runs."""
    import torch

    return torch.profiler.record_function(name) if profile is not None else nullcontext()


def run_cell(cell: spec.Cell, seed: int, seconds: float, device, t_start: float,
             shim=None, profile=None, setup_profile=None) -> Run:
    """Set-up, then the window; ``shim`` (the launch recorder), ``profile``
    (the profiler over the window) and ``setup_profile`` (a
    ``trace.DeviceSection`` over set-up's build of the fixed graph) only
    in a traced run."""
    import torch

    config, traffic = cell.config, cell.traffic
    run = Run(cell, seed, device)
    run.setup_phases["start"] = time.perf_counter() - t_start
    kinds = [(j, spec.driver(config["path"], j["colorer"])) for j in traffic["jobs"]]
    if device.type == "cuda":
        load_kernels(k for _, d in kinds for k in d.KERNELS)
    run.setup_phases["kernels"] = time.perf_counter() - t_start
    per_job = traffic["graph"] == "per_job"
    handles = []
    if not per_job:
        gseed = config["graph_seed"]  # one graph for every seed: the same work, other chains
        graph = run.graphs[gseed] = make_graph(config, gseed)
        if shim is not None:
            shim.start(SETUP_GRAPH)
        with (setup_profile if setup_profile is not None else nullcontext()):
            t0 = time.perf_counter()  # the program's graph set-up: its graph, its colourers
            handles = [d.make(config, j, graph, device) for j, d in kinds]
            _sync(device)
            run.setup_graph_s = time.perf_counter() - t0
        run.setup_trace = setup_profile
        seen = set()
        for (_, d), h in zip(kinds, handles):
            kind, t = d.graph_state(h)
            if t.data_ptr() not in seen:  # colourers of one graph may share it
                seen.add(t.data_ptr())
                run.graph_state.append((gseed, kind, t))
    run.setup_phases["graph"] = time.perf_counter() - t_start
    # warm every kind of job once, on seeds no window job uses
    if shim is not None:
        shim.start(SETUP_WARM)
    wseed = seeds.warm_seed(seed)
    for k, (j, d) in enumerate(kinds):
        h = d.make(config, j, make_graph(config, wseed), device) if per_job else handles[k]
        d.run(h, wseed, k)
        del h
    _sync(device)
    run.setup_s = time.perf_counter() - t_start

    if shim is not None:
        shim.start(WINDOW)
    chain = seeds.chain_seed(seed)
    last = None
    with (profile if profile is not None else nullcontext()):
        with _range(profile, WINDOW):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                i = len(run.jobs)
                k = i % len(kinds)
                j, d = kinds[k]
                with _range(profile, f"colorbench.job.{j['colorer']}"):
                    ta = time.perf_counter()
                    if per_job:
                        gseed = seeds.graph_seed(seed, i)
                        graph = make_graph(config, gseed)
                        h = d.make(config, j, graph, device)
                    else:
                        h = handles[k]
                    res = d.run(h, chain, i)
                    tb = time.perf_counter()
                res["colors"] = _compact(res["colors"])
                run.jobs.append(Job(i, j, gseed, tb - ta if res["conflicts"] == 0 else None,
                                    res))
                if per_job:
                    run.graphs[gseed] = graph
                    last = (gseed, d, h)
                    del h
            _sync(device)
            run.window_s = time.perf_counter() - t0
    if device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if last is not None:
        run.graph_state.append((last[0], *last[1].graph_state(last[2])))
    del handles, last
    return run
