"""The port's segment loop (``utils/segmented.py``) against the JAX
package's, and the port's runs against their own unsegmented selves.

- ``drive_segments``: the same loop under the same fake clock gives the
  same budget sequence, the same hook calls and the same final state as
  JAX's (exact: integer budgets from the same float arithmetic); fixed
  budgets, and a hook that ends the run ends the drive.
- ``MCMCColorer.run`` is invariant to segmenting: the colours, iterations,
  trace and conflicts of a run whose segments are all one body equal those
  of a run in default segments (exact, the same draws in the same order).
"""

import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.utils import segmented as jseg

from mcmc_colorer_tpu_torch import interop
from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
from mcmc_colorer_tpu_torch.utils import segmented as tseg

torch.set_num_threads(2)


class FakeClock:
    """``time.perf_counter`` for both segment loops: the loop advances it by
    ``per_step`` seconds a step it executes."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def drive(module, clock, total, per_step, target_s, grow=8.0, stop_at=None):
    calls = []

    def seg(state, budget):
        steps = min(state + int(budget), total, stop_at if stop_at is not None else total)
        clock.t += per_step * (steps - state)
        calls.append(int(budget))
        return steps

    hooks = []
    final = module.drive_segments(
        seg, 0, lambda s: (s, s >= total), target_s=target_s, grow=grow,
        on_segment=lambda s, steps, b, el: hooks.append((s, steps, b, round(el, 9))),
    )
    return final, calls, hooks


@pytest.mark.parametrize("total, per_step, target_s, grow, stop_at", [
    (37, 1e-9, 1e9, 8.0, None),     # no time pressure: growth by `grow`
    (500, 0.5, 20.0, 8.0, None),    # ~20 s segments: budgets of 40
    (500, 3.0, 20.0, 8.0, None),    # slow steps: budgets of 6
    (200, 0.01, 1.0, 2.0, None),    # slower growth
    (100, 0.2, 20.0, 8.0, 13),      # the loop stops early: the drive ends
])
def test_budget_sequence_matches_jax(monkeypatch, total, per_step, target_s, grow, stop_at):
    clock = FakeClock()
    monkeypatch.setattr("time.perf_counter", clock)
    want = drive(jseg, clock, total, per_step, target_s, grow, stop_at)
    clock.t = 0.0
    got = drive(tseg, clock, total, per_step, target_s, grow, stop_at)
    assert got == want
    assert got[1][0] == tseg.INIT_BUDGET == jseg.INIT_BUDGET == 1
    assert tseg.SEGMENT_TARGET_S == jseg.SEGMENT_TARGET_S


def test_drive_segments_budget_adaptation():
    """Mirrors tests/test_segmented.py:test_drive_segments_budget_adaptation."""
    calls = []

    def seg(state, budget):
        calls.append(int(budget))
        steps, total = state
        return (min(steps + int(budget), total), total)

    final = tseg.drive_segments(seg, (0, 37), lambda s: (s[0], s[0] >= s[1]), target_s=1e9)
    assert final[0] == 37
    assert calls[0] == 1
    assert all(b <= a * 8 for a, b in zip(calls, calls[1:]))


def test_drive_segments_fixed_and_quit():
    """``fixed`` keeps the first budget for every segment (the stepped run's
    ``segment``), and completion is read again after ``on_segment``, so a
    hook that ends the run (the debugger's quit) ends the drive at once."""
    calls = []

    def seg(state, budget):
        calls.append(int(budget))
        return state + int(budget)

    final = tseg.drive_segments(seg, 0, lambda s: (s, s >= 20), init_budget=3, fixed=True,
                                target_s=1e-9)
    assert final == 21 and calls == [3] * 7
    quit_at = []
    calls.clear()
    final = tseg.drive_segments(
        seg, 0, lambda s: (s, s >= 100 or bool(quit_at)), init_budget=4, fixed=True,
        on_segment=lambda s, *_: quit_at.append(s) if s >= 8 else None)
    assert final == 8 and calls == [4, 4] and quit_at == [8]


@pytest.mark.parametrize("backend, layout", [
    ("pallas", "flat"), ("xla", "flat"), ("matmul", "flat"), ("pallas", "bucketed"),
])
def test_mcmc_run_invariant_to_segmenting(medium_er, monkeypatch, backend, layout):
    g = interop.graph_from_jax(medium_er)
    p = MCMCParams(n_colors=max(4, medium_er.max_degree // 2),
                   proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True, taboo_iterations=1)
    colorer = MCMCColorer(g, p, backend=backend, layout=layout, device="cpu")
    whole = colorer.run(seed=7)
    seen = []
    orig = tseg.drive_segments

    def one_body_segments(segment_fn, state, progress_fn, **kw):
        def counted(st, budget):
            seen.append(budget)
            return segment_fn(st, budget)
        return orig(counted, state, progress_fn, **kw)

    monkeypatch.setattr(tseg, "SEGMENT_TARGET_S", 0.0)  # every budget stays 1
    monkeypatch.setattr(tseg, "drive_segments", one_body_segments)
    pieces = colorer.run(seed=7)
    assert len(seen) >= 2 and set(seen) == {1}
    assert np.array_equal(pieces.colors, whole.colors)
    assert pieces.iterations == whole.iterations
    assert np.array_equal(pieces.conflict_trace, whole.conflict_trace)
    assert pieces.extra["final_conflicts"] == whole.extra["final_conflicts"] == 0
    assert pieces.extra["sweeps"] == whole.extra["sweeps"]
