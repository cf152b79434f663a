"""Whole runs of every cell at a tiny size on the CPU (the kernels' plain
versions): the contract line, the import check, the control and the
planted faults, each of which the judge must find."""

import json
import subprocess
import sys

import pytest

from colorbench import faults, spec
from colorbench.run import emit, forbidden_modules, main

from .helpers import dry_run

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
    # on the CPU the device readers find nothing: no roofline, no idle share
    assert not any(k.endswith("roofline_pct") or k == "device.idle_pct" for k in result["metrics"])
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


@pytest.mark.parametrize("name,fails", [("er50k_p001.repet", "balance_r1"),
                                        ("er100k_p01.repet", "unfinished_jobs"),
                                        ("er100k_p01.fresh", "unfinished_jobs")])
def test_a_chain_left_at_its_start_is_not_correct(name, fails):
    """The ELL tailcut repairs a chain that ran no sweep into a valid
    colouring, which only the balance limit sees; the resident NC tailcut
    cannot repair it, and the job ends unfinished."""
    with faults.planted("skip_chain", spec.cell_drivers(spec.cell(name))):
        result, numbers = dry_run(name, seed=21)
    bad = {x.name for x in numbers if not x.ok}
    assert result["correct"] is False and bad == {fails}


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_answer"])
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault):
    with faults.planted(fault, spec.cell_drivers(spec.cell(name))):
        result, _ = dry_run(name, seed=31)
    assert result["correct"] is False
