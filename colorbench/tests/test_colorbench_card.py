"""The benchmark on the card: ``pytest colorbench/tests -q -m card`` on a
machine with an NVIDIA card (each test skips without one)."""

import json
import shutil
import subprocess
import sys

import pytest

from colorbench import spec

pytestmark = pytest.mark.card

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _run(cwd, *args, timeout=400):
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          cwd=cwd, timeout=timeout)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_of_the_first_cell(card, trace):
    out = _run(spec.ROOT, "colorbench.run", "--workload", CELLS[0], "--seed", "4294967311",
               "--seconds", "3", "--trace", str(trace))
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert r["device"]["count"] == 1 and r["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert "device.idle_pct" in r["metrics"]
        assert all(v["value"] <= 105 for k, v in r["metrics"].items() if k.endswith("roofline_pct"))


def test_the_control_on_the_card(card):
    out = _run(spec.ROOT, "colorbench.control", "--workload", CELLS[0], "--seeds", "77",
               "--seconds", "2", "--fault", "skip_repair")
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is False


def test_no_result_without_the_program(card, tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "colorbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "colorbench.run", "--workload", CELLS[0], "--seed", "1",
               "--seconds", "1")
    assert out.returncode != 0 and out.stdout.strip() == ""
