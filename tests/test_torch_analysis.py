"""The port's offline analysis (``mcmc_colorer_tpu_torch/analysis/``)
against the JAX package's (``mcmc_colorer_tpu/analysis/log_parser.py``).

Both parse the same files and must return equal results, floats
compared exactly (the balance index to 1e-12), on three kinds of input:

- logs the JAX CLI wrote (``--mcmcgpu --lubygpu --repet 2`` at ER(100,
  0.1), as ``tests/test_cli_analysis.py`` writes them);
- logs the port's CLI wrote on the CPU (five colorers, two sizes, two
  ``-r`` ratios, ``--repet 2``: ratio 4 leaves the chains at their
  iteration cap, so every metric has data);
- the reference's old ``resultsFile-*`` GPU dialect, written inline.

Then the ports of ``tests/test_cli_analysis.py``'s analysis tests, the
plots on both sides (drawn where matplotlib is installed, ``False``
where it is not), and a subprocess that imports the port's analysis and
finds neither jax nor the JAX package loaded.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mcmc_colorer_tpu.analysis as jax_analysis
from mcmc_colorer_tpu.analysis import log_parser as jax_lp
from mcmc_colorer_tpu.cli import main as jax_main

import mcmc_colorer_tpu_torch.analysis as analysis
from mcmc_colorer_tpu_torch.analysis import log_parser as lp
from mcmc_colorer_tpu_torch.cli import main as cli_main
from mcmc_colorer_tpu_torch.models.base import Coloring

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
PORT_SIZES = (100, 160)
PORT_RATIOS = (1.0, 4.0)
PORT_TAGS = {"MCMC_CPU", "MCMC_GPU", "LUBY", "GFF", "VFF"}
SOURCES = ("jax_cli", "port_cli", "reference_gpu")
DEVICE_TAG = {"jax_cli": "MCMC_TPU", "port_cli": "MCMC_GPU"}

# the reference's OLD GPU-run dialect (pyScripts/logParser.py:56-84), a
# converged run and one at its iteration cap
_GPU_LOG = """\
numCol 4
numColorRatio 1.0
iteration_0 conflicts 55
iteration_1 conflicts 12
iteration_2 conflicts 0
time 1.5
max_iteration_reached no
color_0 30
color_1 34
color_2 36
end_used_colors 3
end_average 25.0
end_variance 6.2
end_standard_deviation 2.5
"""
_GPU_LOG_CAPPED = """\
numCol 3
numColorRatio 2.0
iteration_0 conflicts 80
iteration_1 conflicts 41
time 0.25
max_iteration_reached yes
color_0 52
color_1 0
color_2 48
end_used_colors 2
end_average 33.333333333333336
end_variance 1232.888888888889
end_standard_deviation 35.11251755
"""


@pytest.fixture(autouse=True)
def _no_trace(monkeypatch):
    monkeypatch.setenv("MCMC_COLORER_TRACE", "0")


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """{source: directory of its logs}, each written once."""
    root = tmp_path_factory.mktemp("analysis")
    dirs = {s: root / s for s in SOURCES}
    assert jax_main(["--simulate", "0.1", "-n", "100", "--mcmcgpu", "--lubygpu", "--seed",
                     "11", "--quiet", "--repet", "2", "--outDir", str(dirs["jax_cli"])]) == 0
    for n in PORT_SIZES:
        for ratio in PORT_RATIOS:
            assert cli_main(["--simulate", "0.1", "-n", str(n), "-r", str(ratio), "--mcmccpu",
                             "--mcmcgpu", "--lubygpu", "--grdffgpu", "--vffgpu", "--repet", "2",
                             "--seed", "11", "--quiet", "--outDir", str(dirs["port_cli"]),
                             *CPU]) == 0
    dirs["reference_gpu"].mkdir()
    (dirs["reference_gpu"] / "resultsFile-100-0.1-0.log").write_text(_GPU_LOG)
    (dirs["reference_gpu"] / "resultsFile-100-0.1-1.txt").write_text(_GPU_LOG_CAPPED)
    return dirs


@pytest.mark.parametrize("source", SOURCES)
def test_parsers_equal_jax(logs, source, tmp_path):
    """``parse_results_dir``, each file's own parser and
    ``save_results_json`` give JAX's dicts, key for key and value for
    value."""
    d = logs[source]
    got, want = lp.parse_results_dir(str(d)), jax_lp.parse_results_dir(str(d))
    assert got == want
    assert set(got) == {"jax_cli": {"MCMC_TPU", "LUBY"}, "port_cli": PORT_TAGS,
                        "reference_gpu": {"MCMC_GPU"}}[source]
    for path in sorted(d.iterdir()):
        if path.name.startswith("resultsFile-"):
            assert lp.parse_gpu_results_file(str(path)) == jax_lp.parse_gpu_results_file(
                str(path))
        elif path.suffix == ".log":
            rec = lp.parse_log_file(str(path))
            assert rec == jax_lp.parse_log_file(str(path))
            assert {"nodes", "prob", "histogram", "balancing_index", "iterations",
                    "execution_time_s", "n_colors", "used_colors"} <= rec.keys()
    mine = lp.save_results_json(str(d), str(tmp_path / "port.json"))
    theirs = jax_lp.save_results_json(str(d), str(tmp_path / "jax.json"))
    assert mine == theirs == got
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert json.loads((tmp_path / "port.json").read_text()) == got


@pytest.mark.parametrize("source", SOURCES)
def test_metrics_equal_jax(logs, source):
    """speedups, per-iteration speedups, non-convergence counts, the
    var-col surface (``algo`` given) and every run's balance index."""
    res = lp.parse_results_dir(str(logs[source]))
    assert lp.speedups(res) == jax_lp.speedups(res)
    assert lp.per_iteration_speedups(res) == jax_lp.per_iteration_speedups(res)
    for algo, runs in res.items():
        assert lp.count_non_convergent(runs) == jax_lp.count_non_convergent(runs)
        assert lp.var_col_surface(res, algo) == jax_lp.var_col_surface(res, algo)
        for r in runs:
            n, prob = r.get("nodes", sum(r["histogram"])), r.get("prob", 0.1)
            got = lp.balance_index(r["histogram"], n, prob, r.get("n_colors"))
            want = jax_lp.balance_index(r["histogram"], n, prob, r.get("n_colors"))
            assert abs(got - want) <= 1e-12
            if "balancing_index" in r:  # the colorer's own, as logged
                assert abs(got - r["balancing_index"]) <= 1e-9


def test_port_logs_feed_every_metric(logs):
    """On the port's logs every metric has data: both device pairs at
    both sizes, the ratio cells of the var-col surface under the port's
    default tag, runs at their cap and runs that converged; each
    histogram sums to n and equals its colour file's counts."""
    d = logs["port_cli"]
    res = lp.parse_results_dir(str(d))
    for runs in res.values():
        assert len(runs) == 2 * len(PORT_SIZES) * len(PORT_RATIOS)
        for r in runs:
            colors = np.loadtxt(d / (Path(r["path"]).name[:-4] + "-colors.txt"), dtype=np.int64)
            assert sum(r["histogram"]) == r["nodes"] == len(colors)
            assert np.bincount(colors[:, 1], minlength=len(r["histogram"])).tolist() == r[
                "histogram"]
    for sp in (lp.speedups(res), lp.per_iteration_speedups(res)):
        for pair in ("MCMC_CPU/MCMC_GPU", "LUBY/MCMC_GPU"):
            assert sorted(sp[pair]) == list(PORT_SIZES)
            assert all(np.isfinite(v) and v > 0 for v in sp[pair].values())
    surface = lp.var_col_surface(res)
    assert sorted(surface) == [(r, 0.1) for r in PORT_RATIOS]
    assert surface == jax_lp.var_col_surface(res, algo="MCMC_GPU")
    # the one deliberate difference: JAX's default reads MCMC_TPU runs
    assert jax_lp.var_col_surface(res) == {}
    capped = lp.count_non_convergent(res["MCMC_GPU"])
    assert 0 < capped < len(res["MCMC_GPU"])
    jres = lp.parse_results_dir(str(logs["jax_cli"]))
    assert lp.var_col_surface(jres, "MCMC_TPU") == jax_lp.var_col_surface(jres) != {}


# ---- ports of tests/test_cli_analysis.py's analysis tests ----------------


def test_log_roundtrip_and_analysis(tmp_path):
    out = tmp_path / "res"
    assert cli_main(["--simulate", "0.1", "-n", "100", "--mcmcgpu", "--lubygpu", "--seed", "11",
                     "--quiet", "--repet", "2", "--outDir", str(out), *CPU]) == 0
    results = analysis.parse_results_dir(str(out))
    assert set(results) == {"MCMC_GPU", "LUBY"}
    rec = results["MCMC_GPU"][0]
    assert rec["nodes"] == 100
    assert rec["n_colors"] > 0
    assert sum(rec["histogram"]) == 100
    assert "execution_time_s" in rec and "iterations" in rec
    assert analysis.count_non_convergent(results["MCMC_GPU"]) in (0, 1, 2)
    sp = analysis.speedups(results)
    assert set(sp) == {"LUBY/MCMC_GPU"}
    j = lp.save_results_json(str(out), str(tmp_path / "final.json"))
    assert json.load(open(tmp_path / "final.json")).keys() == j.keys()


def test_balance_index_formula():
    # perfectly balanced: BI = 0
    assert analysis.balance_index([10, 10, 10], 30, 0.5) == 0.0
    # one-off imbalance matches hand computation
    bi = analysis.balance_index([11, 9, 10], 30, 0.5)
    assert abs(bi - np.sqrt(2 / 15)) < 1e-12


def test_balance_index_full_palette():
    """Trailing unused palette colours must not shrink the average:
    avg = n/nCol (coloringMCMC_prints.cu:148-152), not n/len(hist)."""
    h = [15, 15]  # histogram truncated at the largest used colour, nCol=3
    bi = analysis.balance_index(h, 30, 0.5, n_colors=3)
    # avg = 30/3 = 10; Σ_used = 2·(15−10)²; / (30·0.5)
    assert abs(bi - np.sqrt(50 / 15)) < 1e-12
    # without the palette it degrades to len(h) (avg 15 → balanced)
    assert analysis.balance_index(h, 30, 0.5) == 0.0


def test_analysis_bi_matches_coloring_bi(tmp_path):
    """The offline parser's balance index equals the port's
    ``Coloring.balance_index`` for the same run."""
    out = tmp_path / "res"
    assert cli_main(["--simulate", "0.1", "-n", "90", "--mcmcgpu", "--nCol", "40", "--seed", "5",
                     "--quiet", "--outDir", str(out), *CPU]) == 0
    r = analysis.parse_results_dir(str(out))["MCMC_GPU"][0]
    hist = np.zeros(r["n_colors"], np.int64)
    hist[: len(r["histogram"])] = r["histogram"]
    colors = np.repeat(np.arange(r["n_colors"]), hist)
    c = Coloring(colors=colors, n_colors=r["n_colors"])
    got = analysis.balance_index(r["histogram"], r["nodes"], r["prob"], r["n_colors"])
    assert abs(got - c.balance_index(r["prob"])) < 1e-9


def test_reference_gpu_dialect(tmp_path):
    """The reference's OLD GPU-run format (resultsFile-*, parsed by
    pyScripts/logParser.py:56-84) feeds the same analysis pipeline."""
    (tmp_path / "resultsFile-100-0.1-0.log").write_text(_GPU_LOG)
    res = analysis.parse_results_dir(str(tmp_path))
    assert "MCMC_GPU" in res
    r = res["MCMC_GPU"][0]
    assert r["iterations"] == 3  # one iteration_* line per iteration
    assert r["execution_time_s"] == 1.5
    assert r["max_iteration_reached"] is False
    assert r["n_colors"] == 4
    assert r["color_ratio"] == 1.0
    assert r["used_colors"] == 3
    assert r["histogram"] == [30, 34, 36]
    assert r["class_mean"] == 25.0
    assert r["class_std"] == 2.5
    assert r["repetition"] == 0 and r["graph_name"] == "100-0.1"


@pytest.mark.parametrize("device_tag", ["MCMC_TPU", "MCMC_GPU"])
def test_per_iteration_speedups(device_tag):
    results = {
        "MCMC_CPU": [{"nodes": 100, "execution_time_s": 10.0, "iterations": 10}],
        device_tag: [{"nodes": 100, "execution_time_s": 2.0, "iterations": 40}],
    }
    # per-iteration: (10/10) / (2/40) = 20; overall: 10/2 = 5
    sp = analysis.per_iteration_speedups(results)
    assert abs(sp[f"MCMC_CPU/{device_tag}"][100] - 20.0) < 1e-9
    overall = analysis.speedups(results)
    assert abs(overall[f"MCMC_CPU/{device_tag}"][100] - 5.0) < 1e-9
    assert sp == jax_lp.per_iteration_speedups(results)
    assert overall == jax_lp.speedups(results)


# ---- plots ----------------------------------------------------------------

PLOTS = ("speedup", "speedup_per_iteration", "var_col_3d", "balance_index")


def _plot(mod, kind, results, out, algo=None):
    if kind == "speedup":
        return mod.plot_speedup(results, str(out))
    if kind == "speedup_per_iteration":
        return mod.plot_speedup(results, str(out), per_iteration=True)
    if kind == "var_col_3d":
        return (mod.plot_var_col_3d(results, str(out)) if algo is None
                else mod.plot_var_col_3d(results, str(out), algo=algo))
    return mod.plot_balance_index(results, str(out), prob=0.1)


@pytest.mark.parametrize("kind", PLOTS)
@pytest.mark.parametrize("source", ["jax_cli", "port_cli"])
def test_plots_draw_on_both_sides(logs, source, kind, tmp_path):
    """Each plot returns True and writes a PNG on both sides (the port's
    var-col plot by its default tag on its own logs)."""
    pytest.importorskip("matplotlib")
    res = lp.parse_results_dir(str(logs[source]))
    tag = DEVICE_TAG[source]
    mine = _plot(lp, kind, res, tmp_path / "port.png",
                 algo=None if source == "port_cli" else tag)
    theirs = _plot(jax_lp, kind, res, tmp_path / "jax.png", algo=tag)
    assert mine is True and theirs is True
    for name in ("port.png", "jax.png"):
        data = (tmp_path / name).read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 1000


@pytest.mark.parametrize("kind", PLOTS)
def test_plots_return_false_without_matplotlib(kind, monkeypatch, tmp_path):
    """The reference's contract: no matplotlib, no plot, ``False``."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    res = {"MCMC_CPU": [{"nodes": 100, "execution_time_s": 1.0, "iterations": 2}],
           "MCMC_GPU": [{"nodes": 100, "execution_time_s": 0.5, "iterations": 2,
                         "histogram": [50, 50], "prob": 0.1, "color_ratio": 1.0}]}
    for mod in (lp, jax_lp):
        assert _plot(mod, kind, res, tmp_path / "x.png", algo="MCMC_GPU") is False
    assert not (tmp_path / "x.png").exists()


# ---- the package ------------------------------------------------------------


def test_analysis_exports_jax_names_and_imports_no_jax():
    assert analysis.__all__ == jax_analysis.__all__
    for name in analysis.__all__:
        assert getattr(analysis, name) is getattr(lp, name)
    code = ("import sys\n"
            "import mcmc_colorer_tpu_torch.analysis as a\n"
            "assert len(a.__all__) == 7\n"
            "assert not [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "            or m == 'mcmc_colorer_tpu' or m.startswith('mcmc_colorer_tpu.')],"
            " sorted(sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
