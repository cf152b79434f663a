"""What ``BENCHMARK.json`` names, found by name under ``colorbench/``.

- a configuration: ``configs/<config>.json``;
- a traffic mix: ``traffic/<traffic>.json``;
- a metric: ``metrics/<metric>.py`` (its reader);
- a kernel's work count: ``roofline/<kernel>.py``;
- a colourer on a graph path: ``drivers/<path>_<colorer>.py`` (how it is
  built and run, its control and the faults it can have);
- a graph family (a configuration's ``family``): ``families/<family>.py``
  (the graph handed to the program, and its edges for the reference);
- how the program's graph is judged, by the kind its driver reports:
  ``reference/state_<kind>.py``.

Nothing needs an edit to add any of them: a new file and a new entry in
``BENCHMARK.json`` are enough.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


_LOADED: dict = {}


def load_module(path: Path, name: str):
    """The module of a file found by name, loaded once a process."""
    if name in _LOADED:
        return _LOADED[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # a dataclass in the file looks its module up
    spec.loader.exec_module(mod)
    _LOADED[name] = mod
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with what it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _reported(metric: dict, cell: str, e2e_here: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_here


def cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    bench = bench or benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reported(m, name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reported(m, name, names)]
    return Cell(name, w["chips"], config, traffic, e2e, layer)


def reader(metric: str):
    """The reader of a metric: ``metrics/<metric>.py``, whose ``read(run)``
    gives the value or None where the run holds nothing to read."""
    return load_module(HERE / "metrics" / f"{metric}.py", f"colorbench_metric_{metric}")


def roofline(kernel: str):
    """A kernel's work count: ``roofline/<kernel>.py``."""
    return load_module(HERE / "roofline" / f"{kernel}.py", f"colorbench_roofline_{kernel}")


def driver(path: str, colorer: str):
    """How a colourer on a graph path is driven: ``drivers/<path>_<colorer>.py``."""
    name = f"{path}_{colorer}"
    return load_module(HERE / "drivers" / f"{name}.py", f"colorbench_driver_{name}")


def family(name: str):
    """A graph family: ``families/<family>.py``, with ``make(config,
    seed)`` (the graph input the drivers take) and ``reference_edges(config,
    graph, device)`` (its edges, derived by the reference)."""
    return load_module(HERE / "families" / f"{name}.py", f"colorbench_family_{name}")


def state_check(kind: str):
    """How the program's graph of this kind is judged:
    ``reference/state_<kind>.py``, with ``errors(tensor, src, dst, n)``."""
    return load_module(HERE / "reference" / f"state_{kind}.py", f"colorbench_state_{kind}")


def cell_drivers(cell: Cell) -> list:
    """The drivers of a cell's jobs, one for each kind, in order."""
    out = []
    for j in cell.traffic["jobs"]:
        d = driver(cell.config["path"], j["colorer"])
        if all(d.__name__ != x.__name__ for x in out):
            out.append(d)
    return out


def exact_reference(colorer: str):
    """The exact colouring a deterministic colourer must give, where the
    reference has one: ``reference/exact_<colorer>.py``, else None."""
    path = HERE / "reference" / f"exact_{colorer}.py"
    return load_module(path, f"colorbench_exact_{colorer}") if path.exists() else None


def roofline_kernels(per_layer: list[dict]) -> list[str]:
    """The kernels whose ``<kernel>.roofline_pct`` the cell reports."""
    return [m["name"].split(".")[0] for m in per_layer
            if m["name"].endswith(".roofline_pct")]
