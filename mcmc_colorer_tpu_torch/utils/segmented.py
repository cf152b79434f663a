"""Host loop for chain loops run in budgeted segments.

Counterpart of ``mcmc_colorer_tpu/utils/segmented.py``, kept as the
port's own copy.  The JAX package compiles each device loop once with a
budget of body iterations and drives it from the host in segments, so
that no single execution of a TPU program runs long.  The port's loops
are Python loops that read the body's conflict count on the host every
body, so nothing on the card needs cutting: here a segment only sets the
cadence at which a run writes its checkpoint, prints its TRACE line and
polls the debugger.  The segment lengths follow the same rule as JAX's
(``INIT_BUDGET`` = 1, growth at most ``grow`` x a segment, towards
``target_s`` seconds), so a run segments where JAX's would on the same
clock, and a segmented run is bit-equal to an unsegmented one (the body
sequence does not change).
"""

from __future__ import annotations

import time

# seconds a segment aims at: the cadence of checkpoints and TRACE lines
SEGMENT_TARGET_S = 20.0
# the first segment is one body, so the first checkpoint and TRACE line
# come after one sweep, and its time measures a body for the next budget
INIT_BUDGET = 1


def drive_segments(
    segment_fn,
    state,
    progress_fn,
    *,
    init_budget: int = INIT_BUDGET,
    target_s: float | None = None,
    grow: float = 8.0,
    fixed: bool = False,
    on_segment=None,
):
    """Run ``segment_fn(state, budget) -> state`` until ``progress_fn``
    reports completion.

    ``progress_fn(state) -> (steps, done)``: the loop's iteration counter
    and its completion flag.  After each segment the budget scales towards
    ``target_s`` seconds a segment, growing at most ``grow`` x a step; a
    budget is at least 1; ``fixed`` keeps ``init_budget`` for every
    segment.  A segment that executed fewer steps than its budget without
    finishing ends the drive (the loop stopped for its own reasons).
    ``on_segment(state, steps, budget, elapsed)`` runs after each segment
    (checkpoints, TRACE, the debugger), and completion is read again after
    it, so a debugger's quit ends the drive at once.
    """
    if target_s is None:
        target_s = SEGMENT_TARGET_S  # module attribute: patchable in tests
    budget = max(1, int(init_budget))
    prev_steps, done = progress_fn(state)
    while not done:
        t0 = time.perf_counter()
        state = segment_fn(state, budget)
        steps, done = progress_fn(state)
        elapsed = time.perf_counter() - t0
        if on_segment is not None:
            on_segment(state, steps, budget, elapsed)
            done = progress_fn(state)[1]
        executed = max(1, int(steps) - int(prev_steps))
        prev_steps = steps
        if executed < budget and not done:
            break
        if not fixed:
            per = elapsed / executed
            budget = max(1, min(int(budget * grow), int(target_s / max(per, 1e-6))))
    return state
