"""Whole runs of every cell at a tiny size on the CPU (the kernels' plain
versions): the contract line, the import check, the control and the
planted faults, each of which the judge must find."""

import json
import subprocess
import sys
import time
import types

import pytest
import torch

from colorbench import faults, loop, metrics_common, spec
from colorbench import trace as tr
from colorbench.run import emit, forbidden_modules, main

from .helpers import dry_run, tiny, tiny_cell, tiny_path

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("name", CELLS)
def test_dry_run_prints_one_contract_line(name, capsys):
    result, numbers = dry_run(name)
    capsys.readouterr()
    emit(result, numbers)
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert RESULT_KEYS <= set(r) and list(r)[-1] == "checks"
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    want = {m["name"] for m in spec.cell(name).end_to_end}
    assert set(r["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    tail = err.strip().splitlines()[-len(numbers):]
    assert tail == [f"check {x.name} {x.value} limit {x.limit}" for x in numbers]


@pytest.mark.parametrize("name", CELLS)
def test_traced_dry_run_reads_the_per_layer_metrics(name):
    result, _ = dry_run(name, trace=True)
    assert result["correct"] is True
    layer = {m["name"] for m in spec.cell(name).per_layer}
    assert set(result["metrics"]) <= layer
    # on the CPU the device readers find nothing: no roofline, no idle share, no set-up busy time
    assert not any(k.endswith("roofline_pct") or k in ("device.idle_pct", "setup.graph_device_s")
                   for k in result["metrics"])
    assert result["device"]["window_s"] > 0
    bd = result["breakdown"]
    assert len(bd["device_ops"]) <= 10 and 1 <= len(bd["idle_gaps"]) <= 10


def test_without_a_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mcmc_colorer_tpu_torch_fake", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mcmc_colorer_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert forbidden_modules() == ["jax", "mcmc_colorer_tpu"]


def test_a_run_loads_no_jax_module():
    code = ("import sys; from colorbench.tests.helpers import dry_run; "
            "from colorbench.run import forbidden_modules; "
            f"r, _ = dry_run({CELLS[1]!r}); assert r['correct']; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=spec.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


CONTROLS = [(name, c) for name in CELLS
            for c in faults.controls(spec.cell_drivers(spec.cell(name)))]


@pytest.mark.parametrize("name,control", CONTROLS)
def test_the_control_is_not_correct(name, control):
    with faults.planted(control, spec.cell_drivers(spec.cell(name))):
        result, numbers = dry_run(name, seed=21)
    assert result["correct"] is False
    assert any(x.value > x.limit for x in numbers)


SKIP_CHAIN = [name for name in CELLS
              if any("skip_chain" in d.FAULTS for d in spec.cell_drivers(spec.cell(name)))]


@pytest.mark.parametrize("name", SKIP_CHAIN)
def test_a_chain_left_at_its_start_is_not_correct(name):
    """The numbers a chain that ran no sweep fails are its configuration's
    tiny file's ``skip_chain_fails``: the ELL tailcut repairs such a chain
    into a valid colouring, which only the balance limit sees; the
    resident NC tailcut cannot repair it, and the job ends unfinished."""
    fails = set(tiny(spec.cell(name).config["name"])["skip_chain_fails"])
    with faults.planted("skip_chain", spec.cell_drivers(spec.cell(name))):
        result, numbers = dry_run(name, seed=21)
    bad = {x.name for x in numbers if not x.ok}
    assert result["correct"] is False and fails and bad == fails


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_answer"])
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault):
    with faults.planted(fault, spec.cell_drivers(spec.cell(name))):
        result, _ = dry_run(name, seed=31)
    assert result["correct"] is False


def test_every_configuration_has_its_tiny_file():
    bench = spec.benchmark()
    for c in bench["configs"]:
        t = tiny(c["name"])
        assert set(t) <= {"config", "skip_chain_fails", "why"} and t["config"], c["name"]
        full = spec.cell(next(w["name"] for w in bench["workloads"]
                              if w["config"] == c["name"])).config
        assert set(t["config"]) <= set(full), f"{c['name']}: the tiny file overrides no key"
        assert t["config"]["n"] < full["n"]
    for name in SKIP_CHAIN:
        assert tiny(spec.cell(name).config["name"])["skip_chain_fails"], name


def test_a_configuration_without_a_tiny_file_names_the_path():
    with pytest.raises(FileNotFoundError, match=str(tiny_path("no_such_config"))):
        tiny("no_such_config")


@pytest.mark.parametrize("name", CELLS)
def test_the_set_up_section_is_traced_apart_from_the_window(name):
    """In a traced run the fixed graph's build is profiled apart, with the
    recorder's tally apart from the window's; on the CPU its readers find
    no device work."""
    cell = tiny_cell(name)
    kernels = spec.roofline_kernels(cell.per_layer)
    names = {k: spec.roofline(k).KERNEL for k in kernels}
    shim = tr.Recorder(kernels).install()
    prof, setup = tr.Trace(names), tr.DeviceSection(names)
    try:
        run = loop.run_cell(cell, 5, 0.3, torch.device("cpu"), time.perf_counter(), shim=shim,
                            profile=prof, setup_profile=setup)
    finally:
        shim.uninstall()
    run.trace, run.recorder = prof, shim
    fixed = cell.traffic["graph"] == "fixed"
    assert (run.setup_trace is setup) == fixed
    if fixed:
        assert run.setup_graph_s <= setup.window_s <= run.setup_graph_s + 1.0
        assert setup.busy_s == 0 and tr.SETUP_GRAPH in shim.sections
    assert prof.window_s >= 0.3 and tr.WINDOW in shim.sections
    assert metrics_common.setup_busy_s(run) is None
    assert all(metrics_common.setup_roofline_pct(run, k) is None for k in kernels)
    assert all(metrics_common.roofline_pct(run, k) is None for k in kernels)


def test_the_recorder_tallies_each_section_apart(monkeypatch):
    mod = types.ModuleType("colorbench_fake_launcher")
    mod.launch = lambda n_bytes: n_bytes
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    roof = types.SimpleNamespace(KERNEL="fake_kernel", WRAPS=(mod.__name__, "launch"),
                                 OPS_PER_S=1e12, work=lambda args, kwargs, memo: (args[0], 0))
    rec = tr.Recorder([])
    rec.kernels = {"fake": roof}
    rec.install()
    try:
        mod.launch(1.0)  # before any section: not tallied
        rec.start(tr.SETUP_GRAPH)
        mod.launch(3.35e12)
        rec.start(tr.WINDOW)
        mod.launch(3.35e12)
        mod.launch(6.7e12)
    finally:
        rec.uninstall()
    assert mod.launch(5) == 5
    n, s = rec.bound_s("fake", tr.SETUP_GRAPH)
    assert n == 1 and s == pytest.approx(1.0)
    n, s = rec.bound_s("fake")
    assert n == 2 and s == pytest.approx(3.0)
    assert rec.bound_s("fake", "no such section") == (0, 0.0)
