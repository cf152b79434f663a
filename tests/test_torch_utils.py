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
    and cap, by which a profiler trace of a run groups them."""
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


def test_frontier_mcmc_iterations_in_profiler_ranges():
    """The frontier chain's iterations run in ranges named by their cap,
    one an iteration, apart from its tailcut rounds'."""
    from mcmc_colorer_tpu_torch.config import MCMCParams
    from mcmc_colorer_tpu_torch.models.mcmc_active import ActiveMCMCColorer

    g = erdos_renyi(500, 0.05, seed=3)
    # 11 colours without the tailcut: frontier iterations; with it, the
    # chain stops at <= 50 conflicts and the tailcut takes them
    for tailcut in (False, True):
        c = ActiveMCMCColorer(g, MCMCParams(n_colors=11, max_iterations=30, tailcut=tailcut),
                              device="cpu")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            r = c.run(seed=3)
        counts = {e.key: e.count for e in prof.key_averages()}
        by_cap = {int(k.split("=")[1]): v for k, v in counts.items()
                  if k.startswith("mcmc round cap=")}
        assert by_cap == r.extra["frontier_iterations"] and bool(by_cap) != tailcut
        rounds = sum(v for k, v in counts.items() if k.startswith("mcmc tailcut round cap="))
        assert rounds == r.extra["tailcut_rounds"] and (rounds > 0) == tailcut


def test_sources_differ_by_seed_and_repetition():
    """Distinct (seed, repetition) pairs draw distinct streams on the CPU,
    whose generator keeps only the low 32 bits of its seed; repetition 0
    seeds with the seed itself."""
    from mcmc_colorer_tpu_torch.utils.rng import TorchUniformSource, generator_seed

    draws = {(s, r): TorchUniformSource(s, r, "cpu").next(4)
             for s in (0, 3, 5, 2**32 - 1) for r in (0, 1, 2)}
    keys = list(draws)
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            assert not torch.equal(draws[a], draws[b]), (a, b)
    assert generator_seed(5, 0) == 5
    assert len({generator_seed(s, r) for s in range(64) for r in range(64)}) == 64 * 64
