"""The port's spans (``utils/spans.py``) inside the colourers, read from a
CPU profiler session: one ``mc.body`` a sweep with one ``mc.body.read``
in each, one ``mc.tailcut.round`` a tailcut round, one ``mc.sweep.class``
a rectangle a sweep and two ``mc.tailcut.class`` a rectangle a round on
both ELL layouts, one round span a greedy or VFF round, every span
inside its job's ``mc.run.*``; the layout's rectangles in the run's
``extra``; and without a profiler the shared no-op, with the same
colours."""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.graph.container import BucketedEll
from mcmc_colorer_tpu_torch.graph.generate import barabasi_albert, erdos_renyi
from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer
from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer
from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer
from mcmc_colorer_tpu_torch.models.vff import VFFColorer
from mcmc_colorer_tpu_torch.utils import spans

N, P, GRAPH_SEED = 400, 0.05, 7


def _params(n_colors):
    # a palette of max degree / 2 leaves conflicts for the tailcut
    return MCMCParams(n_colors=n_colors, proposal=ProposalKind.BALANCE_DYNAMIC,
                      tailcut=True, max_iterations=20, taboo_iterations=2)


@functools.cache
def _hash_max_degree():
    return ResidentMCMCColorer(N, P, GRAPH_SEED, device="cpu").max_degree


def _resident():
    return ResidentMCMCColorer(N, P, GRAPH_SEED, params=_params(max(4, _hash_max_degree() // 2)),
                               device="cpu")


def _ell():
    g = erdos_renyi(N, P, seed=GRAPH_SEED)
    return MCMCColorer(g, _params(max(4, g.max_degree // 2)), device="cpu")


def _bucketed():
    # max degree ~240: degree classes 8, 32, 128 and ~240 wide
    g = barabasi_albert(3000, 8, seed=GRAPH_SEED)
    return MCMCColorer(g, _params(max(4, g.max_degree // 2)), layout="bucketed", device="cpu")


COLORERS = {
    "resident": (_resident, "mc.run.resident"),
    "ell": (_ell, "mc.run.ell"),
    "bucketed": (_bucketed, "mc.run.ell"),
    "greedy_ff": (lambda: GreedyFFColorer(erdos_renyi(N, P, seed=GRAPH_SEED), device="cpu"),
                  "mc.run.greedy_ff"),
    "vff": (lambda: VFFColorer(erdos_renyi(N, P, seed=GRAPH_SEED), device="cpu"),
            "mc.run.vff"),
}


def _traced(make, seed=3, colorer=None):
    """(the colourer's result, its mc.* spans as (name, start, end, thread))
    of one run, and the construction unless ``colorer`` is given, under a
    CPU profiler session."""
    _hash_max_degree()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = (colorer or make()).run(seed)
    out = [(e.name, e.time_range.start, e.time_range.end, e.thread)
           for e in prof.events() if e.name.startswith("mc.")]
    return r, out


def _count(found, name):
    return sum(1 for s in found if s[0] == name)


def _inside(inner, outer):
    return inner[3] == outer[3] and outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("kind", sorted(COLORERS))
def test_spans_count_the_colourer_work(kind):
    """Bodies, reads, tailcut rounds and greedy rounds against what the
    colourer reports; every span inside the one root span of the job."""
    make, root = COLORERS[kind]
    r, found = _traced(make)
    roots = [s for s in found if s[0].startswith("mc.run.")]
    assert [s[0] for s in roots] == [root]
    for s in found:
        assert s[0] in (root, "mc.hashgen") or _inside(s, roots[0]), s
    assert _count(found, "mc.readback") == 1
    if kind in ("resident", "ell", "bucketed"):
        bodies = [s for s in found if s[0] == "mc.body"]
        assert len(bodies) == r.extra["sweeps"] > 0
        reads = [s for s in found if s[0] == "mc.body.read"]
        assert all(sum(_inside(x, b) for x in reads) == 1 for b in bodies)
        assert len(reads) == len(bodies)
        for step in ("mc.body.draw", "mc.body.p_eff", "mc.body.sweep"):
            assert _count(found, step) == len(bodies)
        assert _count(found, "mc.chain") == 1
        rounds = r.extra["tailcut_rounds"]
        assert rounds >= 1
        assert _count(found, "mc.tailcut.round") == rounds == _count(found, "mc.tailcut.read")
        assert _count(found, "mc.tailcut") == 1
    if kind in ("ell", "bucketed"):
        classes = r.extra["classes"]
        sweeps = [s for s in found if s[0] == "mc.body.sweep"]
        per = [sum(_inside(x, b) for x in found if x[0] == "mc.sweep.class") for b in sweeps]
        assert per == [classes] * len(bodies)
        assert _count(found, "mc.tailcut.class") == 2 * classes * rounds
    if kind == "resident":
        assert _count(found, "mc.hashgen") == 1
        assert _count(found, "mc.sweep.nc") == _count(found, "mc.sweep.propose") == len(bodies)
    if kind == "greedy_ff":
        assert _count(found, "mc.greedy.round") == r.iterations == _count(found, "mc.greedy.read")
    if kind == "vff":
        assert r.iterations >= 1
        assert _count(found, "mc.vff.round") == r.iterations == _count(found, "mc.vff.read")
        # phase 1 is GreedyFF's rounds
        assert _count(found, "mc.greedy.round") >= 1


@pytest.mark.parametrize("kind", sorted(COLORERS))
def test_spans_change_no_colour(kind):
    """A run under the profiler colours as a run without one."""
    make, _ = COLORERS[kind]
    plain = make().run(3)
    traced, _ = _traced(make)
    assert np.array_equal(plain.colors, traced.colors)
    assert plain.iterations == traced.iterations


def test_span_without_a_profiler_is_the_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    assert spans.span("mc.a") is spans.OFF and spans.span("mc.b") is spans.OFF
    with spans.span("mc.a") as x:
        assert x is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span("mc.a") is not spans.OFF


def test_span_is_not_copied_to_the_device_timeline():
    """An operator-scope range: no user-scope range, which kineto would
    copy onto the device's timeline over its kernels."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("mc.probe"):
            torch.ones(3).sum()
        with torch.profiler.record_function("user.probe"):
            torch.ones(3).sum()
    scope = {e.name: e.scope for e in prof.events() if e.name.endswith(".probe")}
    user = scope["user.probe"]
    assert scope["mc.probe"] != user


@pytest.mark.parametrize("kind", ["ell", "bucketed"])
def test_extra_counts_the_rectangles_and_the_ids_a_sweep_reads(kind):
    """``classes``: the flat ELL's one rectangle, or each degree class;
    ``gather_ids``: n_pad · d_pad, or ``BucketedEll.gather_elements``."""
    colorer = COLORERS[kind][0]()
    ell = colorer.ell
    x = colorer.run(3).extra
    if kind == "bucketed":
        assert isinstance(ell, BucketedEll) and len(ell.slices) >= 2
        assert x["classes"] == len(ell.slices)
        assert x["gather_ids"] == ell.gather_elements == sum(s.h_pad * s.d_pad
                                                             for s in ell.slices)
    else:
        assert x["classes"] == 1 and x["gather_ids"] == ell.n_pad * ell.d_pad


def test_a_class_span_around_each_kernel_call_whatever_its_bands(monkeypatch):
    """Rows cut into several bands on the CPU give one ``mc.sweep.class``
    around each band's K2 call and one ``mc.tailcut.class`` around each
    K3 tailcut call and each lower-movable call, with the same colours as
    unbanded."""
    from mcmc_colorer_tpu_torch.models import mcmc
    from mcmc_colorer_tpu_torch.ops import firstfit, resample

    whole = _bucketed().run(3)
    monkeypatch.setattr(mcmc, "_FUSED_NC_BYTES_CAP", 128 * 128 * mcmc._SLOT_BYTES)
    calls = {"k2": 0, "tailcut": 0}

    def counted(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(resample, "resample_sweep", counted("k2", resample.resample_sweep))
    for name in ("first_fit", "lower_movable"):
        monkeypatch.setattr(firstfit, name, counted("tailcut", getattr(firstfit, name)))
    colorer = _bucketed()
    r, found = _traced(None, colorer=colorer)
    assert np.array_equal(r.colors, whole.colors)
    assert _count(found, "mc.sweep.class") == calls["k2"]
    assert calls["k2"] > r.extra["classes"] * r.extra["sweeps"]  # more bands than rectangles
    assert _count(found, "mc.tailcut.class") == calls["tailcut"]
    assert calls["tailcut"] > 2 * r.extra["classes"] * r.extra["tailcut_rounds"] > 0
