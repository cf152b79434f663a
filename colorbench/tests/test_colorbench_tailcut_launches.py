"""``tailcut.ell_launches_per_round`` on event lists made by hand: the
launches whose host start lies inside an ``mc.tailcut.round`` span, over
those spans; None on the resident path (whose NC tailcut rounds carry the
same span name) and without a device."""

import types

import pytest

from colorbench import spans, spec
from colorbench.tests.test_colorbench_spans import Ev

METRIC = "tailcut.ell_launches_per_round"


def _tailcut(t, rounds, corr0):
    """One tailcut at ``t`` ns: ``rounds[k]`` launches inside round k's
    span, one kernel on the device each, and a copy outside the rounds."""
    ev = [Ev("mc.tailcut", t, 1_000_000),
          Ev("cudaMemcpyAsync", t + 10, 50, corr=corr0 + 999)]
    for k, n in enumerate(rounds):
        r0 = t + 100 + 100_000 * k
        ev.append(Ev("mc.tailcut.round", r0, 90_000))
        for j in range(n):
            at = r0 + 10 + 1000 * j
            corr = corr0 + 100 * k + j
            ev.append(Ev("cudaLaunchKernel" if j else "cudaMemsetAsync", at, 50, corr=corr))
            ev.append(Ev("first_fit_kernel", at + 500, 200, device=True, corr=corr))
    return ev


def _run(events, path):
    run = types.SimpleNamespace(trace=object(), config={"path": path})
    run.__dict__[spans._CACHE] = spans.Spans.from_events(events)
    return run


@pytest.mark.parametrize("path", ["ell", "hash_ell"])
def test_launches_inside_the_rounds_over_the_rounds(path):
    ev = _tailcut(0, [12, 9, 9], 0) + _tailcut(5_000_000, [6], 1000)
    assert spec.reader(METRIC).read(_run(ev, path)) == 9.0  # (12 + 9 + 9 + 6) / 4


def test_none_on_the_resident_path_and_without_a_device():
    ev = _tailcut(0, [12, 9], 0)
    assert spec.reader(METRIC).read(_run(ev, "resident")) is None
    host_only = [e for e in ev if e.device_type() != "DeviceType.CUDA"]
    assert spec.reader(METRIC).read(_run(host_only, "ell")) is None
