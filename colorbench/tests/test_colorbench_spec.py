"""BENCHMARK.json against the contract, and every name it gives resolved
to its file under colorbench/."""

import json
import re

import pytest

from colorbench import faults, spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["colorbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    for text in ([w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]] + [c["why"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_every_file(name):
    c = spec.cell(name)
    assert c.chips == 1
    assert c.config["name"] in {x["name"] for x in BENCH["configs"]}
    fam = spec.family(c.config["family"])
    assert callable(fam.make) and callable(fam.reference_edges)
    for j in c.traffic["jobs"]:
        d = spec.driver(c.config["path"], j["colorer"])
        assert callable(d.make) and callable(d.run) and callable(d.graph_state)
        assert callable(d.neighbor_of) and isinstance(d.BALANCED, bool)
        assert len(d.COLORER) == 2 and all(x in d.FAULTS for x in d.CONTROLS)
        for k in d.KERNELS:
            assert spec.roofline(k).KERNEL
    assert faults.controls(spec.cell_drivers(c)), f"{name} has no control"
    for kind in ("packed", "ell"):
        assert callable(spec.state_check(kind).errors)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]).read)
    for m in c.per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves {m['moves']}, which {name} does not report"


def test_readers_state_what_benchmark_json_says():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        r = spec.reader(m["name"])
        assert (r.SOURCE, r.UNIT) == (m["source"], m["unit"]), m["name"]
        if "layer" in m:
            assert (r.LAYER, r.MOVES) == (m["layer"], m["moves"]), m["name"]


def test_configs_and_files():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in used and c["file"].startswith("colorbench/")
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)


def test_balance_limits_name_the_ratios_the_traffic_runs():
    for w in BENCH["workloads"]:
        c = spec.cell(w["name"])
        limits = c.config.get("balance_limit", {})
        ratios = {f"{j.get('num_col_ratio', 1):g}" for j in c.traffic["jobs"]
                  if spec.driver(c.config["path"], j["colorer"]).BALANCED}
        assert set(limits) <= ratios | {f"{r:g}" for r in (1, 2, 4)}
        assert all(isinstance(v, float) and v > 0 for v in limits.values())


def test_roofline_kernels_named_by_metrics_exist():
    """Driven by the data: every kernel that a ``<kernel>.roofline_pct``
    metric or a driver's KERNELS names has its ``roofline/<kernel>.py``,
    which wraps a launcher of the port and states a peak; and every such
    file is named by one of them."""
    files = {p.stem for p in (spec.HERE / "roofline").glob("*.py") if p.stem != "__init__"}
    by_metric = set(spec.roofline_kernels(BENCH["per_layer"]))
    by_driver = {k for w in CELLS for d in spec.cell_drivers(spec.cell(w)) for k in d.KERNELS}
    assert by_metric and by_metric <= files and by_driver <= files
    assert files <= by_metric | by_driver, f"unused: {files - by_metric - by_driver}"
    for k in by_metric | by_driver:
        r = spec.roofline(k)
        assert isinstance(r.KERNEL, str) and r.KERNEL and callable(r.work)
        assert len(r.WRAPS) == 2 and r.WRAPS[0].startswith("mcmc_colorer_tpu_torch.")
        assert r.OPS_PER_S > 0
