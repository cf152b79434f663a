"""The readers of the program's spans (``colorbench/spans.py``) on event
lists made by hand: their arithmetic, None without spans, launches linked
to their device intervals by correlation id, idle gaps named by span, and
on the card a traced run of every cell that reads them."""

import json
import subprocess
import sys
import types

import pytest

from colorbench import spans, spec


class Ev:
    """The fields of a kineto event that the readers use."""

    def __init__(self, name, start, dur, device=False, corr=0, activity=None):
        self._v = (name, start, dur, "DeviceType.CUDA" if device else "DeviceType.CPU", corr)
        if activity is not None:
            self.activity_type = activity

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def _body(t, launches, host_ms=1.0, read_ms=0.5, corr0=0, kernel_ns=1000):
    """One chain body at ``t`` ns: ``launches`` launches in its sweep, each
    with a kernel, then a read of ``read_ms``."""
    ms = 1_000_000
    end = t + int((host_ms + read_ms) * ms)
    ev = [Ev("mc.body", t, end - t), Ev("mc.body.sweep", t + 10, int(host_ms * ms) - 20),
          Ev("mc.body.read", t + int(host_ms * ms), int(read_ms * ms))]
    for k in range(launches):
        at = t + 100 + 1000 * k
        ev.append(Ev("cudaLaunchKernel", at, 50, corr=corr0 + k))
        ev.append(Ev("some_kernel", at + 5000, kernel_ns, device=True, corr=corr0 + k))
    return ev


def _run(events, path="ell"):
    run = types.SimpleNamespace(trace=object(), config={"path": path})
    run.__dict__[spans._CACHE] = spans.Spans.from_events(events)
    return run


def _read(metric, run):
    return spec.reader(metric).read(run)


def test_ell_host_time_and_launches_a_sweep():
    ev = _body(0, 4, host_ms=1.0, read_ms=0.5) + _body(10_000_000, 6, host_ms=2.0, read_ms=1.0,
                                                        corr0=100)
    run = _run(ev)
    # the host's own time: (1.5 - 0.5 + 3.0 - 1.0) / 2 bodies
    assert _read("chain.ell_host_ms_per_sweep", run) == pytest.approx(1.5)
    assert _read("chain.ell_launches_per_sweep", run) == 5.0
    assert _read("chain.resident_propose_ms_per_sweep", run) is None  # an ELL run


def test_greedy_launches_over_both_round_kinds():
    ev = [Ev("mc.greedy.round", 0, 1000), Ev("mc.vff.round", 2000, 1000),
          Ev("mc.vff.round", 4000, 1000)]
    ev += [Ev("cudaLaunchKernel", t, 1, corr=t) for t in (10, 20, 30, 2010, 4010, 4020)]
    ev += [Ev("cudaMemcpyAsync", 4030, 1, corr=9), Ev("cudaMemsetAsync", 4040, 1, corr=8),
           Ev("cuLaunchKernelEx", 4050, 1, corr=7), Ev("cudaStreamSynchronize", 4060, 1)]
    ev += [Ev("k", 9000, 1, device=True, corr=1)]
    ev += [Ev("cudaLaunchKernel", 1500, 1, corr=77)]  # between rounds: no round's
    # 3 + 1 + 5 launches, copies and sets over 3 rounds
    assert _read("greedy.launches_per_round", _run(ev)) == 3.0


def test_device_time_is_linked_by_correlation_id():
    ms = 1_000_000
    ev = [Ev("mc.body", 0, 10 * ms), Ev("mc.sweep.propose", 1000, 5 * ms),
          Ev("mc.sweep.nc", 6 * ms, ms)]
    ev += [Ev("cudaLaunchKernel", 2000, 10, corr=1), Ev("cudaLaunchKernel", 3000, 10, corr=2),
           Ev("cudaLaunchKernel", 6 * ms + 10, 10, corr=3)]
    # the kernels run after the span has closed: linked by id, not by time
    ev += [Ev("propose_a", 20 * ms, 2 * ms, device=True, corr=1),
           Ev("propose_b", 22 * ms, ms, device=True, corr=2),
           Ev("packed_nc", 23 * ms, 4 * ms, device=True, corr=3),
           # a user-scope range's copy on the device's timeline: no work
           Ev("gpu_user_annotation", 20 * ms, 3 * ms, device=True, corr=2,
              activity="ActivityType.GPU_USER_ANNOTATION")]
    run = _run(ev, path="resident")
    assert _read("chain.resident_propose_ms_per_sweep", run) == pytest.approx(3.0)
    assert run.__dict__[spans._CACHE].device_ns("mc.sweep.nc") == 4 * ms


def test_hashgen_device_ms_a_graph():
    ms = 1_000_000
    ev = []
    for g in range(2):
        t = g * 100 * ms
        ev += [Ev("mc.hashgen", t, 50 * ms)]
        ev += [Ev("cudaLaunchKernel", t + k * 1000 + 1, 5, corr=g * 10 + k) for k in range(3)]
        ev += [Ev("xor", t + 60 * ms, (g + 1) * ms, device=True, corr=g * 10 + k)
               for k in range(3)]
    assert _read("hashgen.device_ms_per_graph", _run(ev, path="resident")) == pytest.approx(4.5)


def test_none_without_spans_or_without_a_device():
    ev = [Ev("aten::add", 0, 10), Ev("cudaLaunchKernel", 1, 1, corr=1),
          Ev("k", 5, 5, device=True, corr=1)]
    for m, path in (("chain.ell_host_ms_per_sweep", "ell"), ("chain.ell_launches_per_sweep", "ell"),
                    ("greedy.launches_per_round", "ell"),
                    ("chain.resident_propose_ms_per_sweep", "resident"),
                    ("hashgen.device_ms_per_graph", "resident")):
        assert _read(m, _run(ev, path)) is None
    # spans but no device work (a run on the CPU): the device readers read nothing
    cpu = [Ev("mc.body", 0, 100), Ev("mc.body.read", 50, 10)]
    assert _read("chain.ell_launches_per_sweep", _run(cpu)) is None
    assert _read("chain.ell_host_ms_per_sweep", _run(cpu)) == pytest.approx(90 / 1e6)


def test_no_replay_where_the_program_has_no_spans(monkeypatch):
    monkeypatch.setattr(spans, "program_has_spans", lambda: False)
    monkeypatch.setattr(spans, "replay", lambda run: pytest.fail("replayed"))
    run = types.SimpleNamespace(trace=object(), config={"path": "ell"})
    assert spans.of(run) is None
    assert _read("chain.ell_launches_per_sweep", run) is None
    untraced = types.SimpleNamespace(trace=None, config={"path": "ell"})
    assert spans.of(untraced) is None


def test_idle_gap_named_by_its_span_and_host_range():
    ev = [Ev("colorbench.job.mcmc", 0, 1000), Ev("mc.run.ell", 10, 980),
          Ev("mc.body", 20, 900), Ev("mc.body.p_eff", 100, 400), Ev("aten::ge", 200, 200),
          Ev("mc.body.read", 600, 100),
          Ev("k1", 0, 100, device=True, corr=1), Ev("k2", 500, 500, device=True, corr=2),
          Ev("colorbench.job.mcmc", 0, 1000, device=True, corr=3)]  # a range's copy: no work
    gaps = spans.Spans.from_events(ev).named_gaps()
    assert gaps == [["mc.body.p_eff > aten::ge", pytest.approx(400 / 1e9)]]
    hs, he, hn = spans.Spans.from_events(ev).host
    assert spans.gap_name(550, hs, he, hn) == "mc.body"
    assert spans.gap_name(5, hs, he, hn) == "colorbench.job.mcmc"
    assert spans.gap_name(650, hs, he, hn) == "mc.body.read"


PROGRAM_SPAN_METRICS = ["chain.ell_host_ms_per_sweep", "chain.ell_launches_per_sweep",
                        "greedy.launches_per_round", "chain.resident_propose_ms_per_sweep",
                        "hashgen.device_ms_per_graph"]


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_a_traced_run_reads_every_span_metric_its_cell_lists(card, cell):
    out = subprocess.run([sys.executable, "-m", "colorbench.run", "--workload", cell, "--seed",
                          "4294967329", "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    listed = {m["name"] for m in spec.cell(cell).per_layer} & set(PROGRAM_SPAN_METRICS)
    assert listed <= set(r["metrics"]) and all(r["metrics"][m]["value"] > 0 for m in listed)
    # the program's spans leave no range on the device's timeline
    assert not any(n.startswith("mc.") for n, _ in r["breakdown"]["device_ops"])
