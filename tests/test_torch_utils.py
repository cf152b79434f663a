"""The port's small utilities: the stopwatch, the device-memory reader and
the profiler range of a frontier round."""

import functools
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mcmc_colorer_tpu.utils.timer import Timer as JTimer

from mcmc_colorer_tpu_torch.graph.generate import erdos_renyi
from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer
from mcmc_colorer_tpu_torch.models.luby import LubyColorer
from mcmc_colorer_tpu_torch.models.vff import VFFColorer
from mcmc_colorer_tpu_torch.utils.memtrack import device_memory_stats
from mcmc_colorer_tpu_torch.utils.timer import Timer


@pytest.mark.parametrize("cls", [Timer, JTimer])
def test_timer(cls):
    """The port's stopwatch behaves as the JAX package's."""
    t = cls()
    assert t.duration_ms == 0.0
    with t:
        time.sleep(0.01)
    assert t.duration_ms >= 10.0
    assert t.stop() >= t.duration_ms >= 10.0
    assert t.start().duration_ms < 10.0


def test_device_memory_stats_without_a_card(monkeypatch):
    assert device_memory_stats("cpu") == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_memory_stats() == {}


@pytest.mark.parametrize("loop", ["gff", "vff", "luby"])
def test_frontier_rounds_in_profiler_ranges(loop):
    """Each frontier round runs in one profiler range named by its loop
    and cap, which is how measure_kernels.py --colorers groups them."""
    g = erdos_renyi(500, 0.05, seed=3)
    if loop == "gff":
        c = GreedyFFColorer(g, active=True, device="cpu")
        run = c.run
    elif loop == "vff":
        c = VFFColorer(g, active=True, device="cpu")
        run = c.run
    else:
        c = LubyColorer(g, active=True, device="cpu")
        run = functools.partial(c.run, seed=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = run()
    counts = {e.key: e.count for e in prof.key_averages() if e.key.startswith(f"{loop} round cap=")}
    assert counts and all(int(k.split("=")[1]) % 128 == 0 for k in counts)
    rounds = {"gff": r.iterations, "vff": r.iterations, "luby": r.extra.get("rounds")}[loop]
    assert sum(counts.values()) == rounds
