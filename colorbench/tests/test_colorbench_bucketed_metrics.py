"""The readers of the degree-bucketed path on event lists and runs made by
hand: K2's device time inside the ``mc.sweep.class`` spans and the
launches inside ``mc.body``, over the bodies; the tailcut's kernel time
inside the ``mc.tailcut.class`` spans, over the rounds; the chain's ms
from the jobs, and the ELL readers the cell shares (the tailcut's ms, K2's
and K3's roofline shares); and None off the bucketed path, without a
device, or where the program has no class span (a parent without it)."""

import types

import pytest

from colorbench import spans, spec
from colorbench.tests.test_colorbench_spans import Ev

MS = 1_000_000


def _body(t, classes, corr0):
    """One body at ``t`` ns: a draw launch, then ``classes`` class spans
    with one K2 launch each (its kernel ``k + 1`` ms on the device), and a
    read."""
    ev = [Ev("mc.body", t, 20 * MS), Ev("cudaLaunchKernel", t + 10, 5, corr=corr0),
          Ev("draw_kernel", t + MS, MS, device=True, corr=corr0)]
    for k in range(classes):
        at = t + 100 + 1000 * k
        ev += [Ev("mc.sweep.class", at, 900), Ev("cudaLaunchKernel", at + 10, 5, corr=corr0 + k + 1),
               Ev("resample_kernel", t + 2 * MS, (k + 1) * MS, device=True, corr=corr0 + k + 1)]
    ev.append(Ev("cudaMemcpyAsync", t + 10 * MS, 5, corr=corr0 + 99))
    return ev


def _run(events, path="bucketed", jobs=()):
    run = types.SimpleNamespace(trace=object(), config={"path": path}, jobs=list(jobs),
                                recorder=None)
    run.__dict__[spans._CACHE] = spans.Spans.from_events(events)
    return run


def _read(metric, run):
    return spec.reader(metric).read(run)


def test_k2_device_ms_and_launches_a_sweep():
    ev = _body(0, 4, 0) + _body(50 * MS, 4, 100)
    run = _run(ev)
    assert _read("chain.bucketed_k2_device_ms_per_sweep", run) == pytest.approx(10.0)
    # a draw, four K2 launches and a read a body
    assert _read("chain.bucketed_launches_per_sweep", run) == 6.0


def test_none_off_the_path_without_a_device_or_without_class_spans():
    ev = _body(0, 3, 0)
    for m in ("chain.bucketed_k2_device_ms_per_sweep", "chain.bucketed_launches_per_sweep"):
        assert _read(m, _run(ev, path="ell")) is None
        assert _read(m, _run([e for e in ev if e.device_type() != "DeviceType.CUDA"])) is None
    parent = [e for e in ev if e.name() != "mc.sweep.class"]
    assert _read("chain.bucketed_k2_device_ms_per_sweep", _run(parent)) is None
    assert _read("chain.bucketed_launches_per_sweep", _run(parent)) == 5.0
    untraced = types.SimpleNamespace(trace=None, config={"path": "bucketed"})
    assert _read("chain.bucketed_k2_device_ms_per_sweep", untraced) is None


def _job(sweeps, chain_s, tailcut_s):
    return types.SimpleNamespace(seconds=1.0, result={"sweeps": sweeps, "chain_s": chain_s,
                                                      "tailcut_s": tailcut_s})


def test_the_chain_and_tailcut_ms_from_the_jobs():
    jobs = [_job(4, 0.04, 0.010), _job(6, 0.08, 0.020)]
    run = _run([], jobs=jobs)
    assert _read("chain.bucketed_ms_per_sweep", run) == pytest.approx(12.0)
    assert _read("chain.bucketed_ms_per_sweep", _run([], path="ell", jobs=jobs)) is None
    # the ELL tailcut's reader takes the bucketed path's jobs as they are
    assert _read("tailcut.ell_ms_per_job", run) == pytest.approx(15.0)


def _round(t, classes, corr0):
    """One tailcut round at ``t`` ns: ``classes`` K3 calls, then as many
    lower-movable calls, each in a class span with one launch (K3's
    ``k + 1`` ms on the device, each lower-movable 0.5 ms), and a read."""
    ev = [Ev("mc.tailcut.round", t, 20 * MS)]
    for k in range(2 * classes):
        at = t + 100 + 1000 * k
        dev_ms = (k + 1) * MS if k < classes else MS // 2
        ev += [Ev("mc.tailcut.class", at, 900),
               Ev("cudaLaunchKernel", at + 10, 5, corr=corr0 + k),
               Ev("tailcut_kernel", t + 2 * MS, dev_ms, device=True, corr=corr0 + k)]
    ev.append(Ev("cudaMemcpyAsync", t + 10 * MS, 5, corr=corr0 + 99))
    return ev


def test_the_tailcut_kernel_ms_a_round():
    ev = _round(0, 3, 0) + _round(50 * MS, 3, 100)
    # 1 + 2 + 3 ms of K3 and three 0.5 ms lower-movable launches a round
    assert _read("tailcut.bucketed_device_ms_per_round", _run(ev)) == pytest.approx(7.5)
    assert _read("tailcut.bucketed_device_ms_per_round", _run(ev, path="ell")) is None
    parent = [e for e in ev if e.name() != "mc.tailcut.class"]
    assert _read("tailcut.bucketed_device_ms_per_round", _run(parent)) is None
    host_only = [e for e in ev if e.device_type() != "DeviceType.CUDA"]
    assert _read("tailcut.bucketed_device_ms_per_round", _run(host_only)) is None


def test_k2_and_k3_roofline_shares_read_the_bucketed_run():
    """The cell shares ``k2.roofline_pct`` and ``k3.roofline_pct``: each
    reads the bucketed run's recorder and trace, and the cell's metrics
    have the run install both recorders."""
    rec = types.SimpleNamespace(kernels={"k2": None, "k3": None},
                                bound_s=lambda k, section: (3, 0.25 if k == "k2" else 0.1))
    run = types.SimpleNamespace(config={"path": "bucketed"}, recorder=rec,
                                trace=types.SimpleNamespace(kernel_s={"k2": 1.0, "k3": 0.5}))
    assert _read("k2.roofline_pct", run) == pytest.approx(25.0)
    assert _read("k3.roofline_pct", run) == pytest.approx(20.0)
    cell = spec.cell("ba1m_m8.repet")
    assert sorted(spec.roofline_kernels(cell.per_layer)) == ["k2", "k3"]
