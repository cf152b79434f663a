"""``chain.resident_propose_launches_per_sweep`` on event lists made by
hand: the launches whose host start lies inside an ``mc.sweep.propose``
span, over the ``mc.body`` spans; None on the ELL path and without a
device."""

import types

from colorbench import spans, spec
from colorbench.tests.test_colorbench_spans import Ev

METRIC = "chain.resident_propose_launches_per_sweep"


def _resident_body(t, propose_launches, other_launches, corr0):
    """One resident body at ``t`` ns: K1 and its neighbours outside the
    proposal, ``propose_launches`` inside its span."""
    ev = [Ev("mc.body", t, 100_000), Ev("mc.sweep.nc", t + 10, 20_000),
          Ev("mc.sweep.propose", t + 30_000, 30_000)]
    for k in range(other_launches):
        ev.append(Ev("cudaLaunchKernel", t + 100 + 100 * k, 50, corr=corr0 + k))
    for k in range(propose_launches):
        at = t + 30_100 + 1000 * k
        ev.append(Ev("cudaLaunchKernel" if k else "cudaMemsetAsync", at, 50,
                     corr=corr0 + 100 + k))
        ev.append(Ev("propose_kernel", at + 5000, 500, device=True, corr=corr0 + 100 + k))
    return ev


def _run(events, path):
    run = types.SimpleNamespace(trace=object(), config={"path": path})
    run.__dict__[spans._CACHE] = spans.Spans.from_events(events)
    return run


def test_launches_inside_the_proposal_over_the_bodies():
    ev = (_resident_body(0, 5, 3, 0) + _resident_body(1_000_000, 3, 2, 1000)
          + _resident_body(2_000_000, 4, 9, 2000))
    assert spec.reader(METRIC).read(_run(ev, "resident")) == 4.0  # (5 + 3 + 4) / 3


def test_none_on_the_ell_path_and_without_a_device():
    ev = _resident_body(0, 5, 3, 0)
    assert spec.reader(METRIC).read(_run(ev, "ell")) is None
    host_only = [e for e in ev if e.device_type() != "DeviceType.CUDA"]
    assert spec.reader(METRIC).read(_run(host_only, "resident")) is None
