"""The port's baseline and validation scripts (``mcmc_colorer_tpu_torch/
scripts/``) against the JAX package's (``scripts/``, loaded by path), on
the CPU at tiny sizes.

- The host chain is the same numpy code on the same graph and seeds in
  both packages, so config 1 (``--small``), ``validate_stats``'s
  sequential summaries and a matrix cell's sequential entry equal JAX's
  exactly.
- ``cell_checks`` gives JAX's verdicts on every cell of the JAX record
  ``docs/validate_matrix.json`` (read, never written).
- ``run_baseline_configs --small --device cpu`` in a subprocess writes a
  report whose ``valid`` entries are all true, with JAX's report keys but
  the documented ones.
- ``validate_matrix``'s full loop runs past its first cell (the JAX
  script raises ``NameError`` there: ``s`` and ``d`` are never bound in
  its ``main``).
- Without a card and without ``--device cpu`` each script raises before
  it writes anything; none imports jax; the default outputs lie under the
  checkout's ``build/``.
"""

import copy
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mcmc_colorer_tpu_torch.graph.generate import erdos_renyi
from mcmc_colorer_tpu_torch.scripts import BUILD_DIR
from mcmc_colorer_tpu_torch.scripts import run_baseline_configs as rbc
from mcmc_colorer_tpu_torch.scripts import validate_matrix as vm
from mcmc_colorer_tpu_torch.scripts import validate_stats as vs

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ("run_baseline_configs", "validate_stats", "validate_matrix")


def load_jax_script(name, monkeypatch):
    """The JAX package's ``scripts/<name>.py`` as a module, with XLA's
    persistent cache off and ``sys.path`` restored afterwards."""
    monkeypatch.setenv("MCMC_COLORER_COMPILE_CACHE", "0")
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


def test_config1_matches_jax_script(monkeypatch, tmp_path):
    """JAX's ``main --small`` up to its config-2 graph, its config-1 entry
    caught where it prints it."""
    mod = load_jax_script("run_baseline_configs", monkeypatch)
    seen = {}
    orig_er = mod.erdos_renyi

    def er(n, p, seed, **kw):
        if seed != rbc.CONFIG1_SEED:
            raise _Stop
        return orig_er(n, p, seed=seed, **kw)

    monkeypatch.setattr(mod, "erdos_renyi", er)
    monkeypatch.setattr(mod, "print", lambda *a, **k: seen.setdefault(a[0], a[1:]),
                        raising=False)
    monkeypatch.setattr(sys, "argv", ["run_baseline_configs.py", "--small", "--out",
                                      str(tmp_path / "jax.json")])
    with pytest.raises(_Stop):
        mod.main()
    want = seen["config1:"][0]
    got = rbc.config1(True, torch.device("cpu"))["config1_sequential"]
    assert got.keys() == want.keys()
    assert {k: v for k, v in got.items() if k != "seconds"} == {
        k: v for k, v in want.items() if k != "seconds"}
    assert got["valid"] is True and got["n"] == 200


def test_validate_stats_matches_jax_script(monkeypatch, tmp_path):
    mod = load_jax_script("validate_stats", monkeypatch)
    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["validate_stats.py", "--seeds", "3", "--n", "200",
                                      "--out", str(out)])
    assert mod.main() == 0
    want = json.loads(out.read_text())
    got = vs.validate(n=200, p=0.1, seeds=3, device="cpu")
    assert got["config"] == want["config"]
    assert got["sequential"] == want["sequential"]
    assert got["parallel"].keys() == want["parallel"].keys()
    assert got["checks"].keys() == want["checks"].keys() and all(got["checks"].values())
    assert vs.main(["--seeds", "2", "--n", "200", "--device", "cpu", "--out",
                    str(tmp_path / "port.json")]) == 0
    assert json.loads((tmp_path / "port.json").read_text())["config"]["seeds"] == 2


def test_cell_checks_match_jax_on_its_record(monkeypatch):
    mod = load_jax_script("validate_matrix", monkeypatch)
    record = json.loads((ROOT / "docs" / "validate_matrix.json").read_text())
    assert len(record["cells"]) == len(vm.DENSITIES) * len(vm.RATIOS)
    assert (vm.DENSITIES, vm.RATIOS) == (mod.DENSITIES, mod.RATIOS)
    for c in record["cells"]:
        ours, theirs = copy.deepcopy(c), copy.deepcopy(c)
        got, want = vm.cell_checks(ours), mod.cell_checks(theirs)
        assert got == want and got == c["checks"], (c["p"], c["ratio"])
        assert ours["sequential_stall_rate"] == theirs["sequential_stall_rate"]


def test_matrix_cell_sequential_matches_jax(monkeypatch):
    """A cell at ER(300, 0.04), ratio 2, 2 seeds: the sequential entry
    equals JAX's ``cell`` on its own chain; the device chains and the
    variant effect run and the verdicts hold."""
    from mcmc_colorer_tpu.config import MCMCParams as JParams
    from mcmc_colorer_tpu.config import ProposalKind as JKind
    from mcmc_colorer_tpu.graph.generate import erdos_renyi as j_er
    from mcmc_colorer_tpu.models.mcmc_sequential import SequentialMCMCColorer as JSeq

    mod = load_jax_script("validate_matrix", monkeypatch)
    g, jg = erdos_renyi(300, 0.04, seed=777), j_er(300, 0.04, seed=777)
    c = vm.matrix_cell(g, 0.04, 2.0, 2, device="cpu")
    jp = JParams(n_colors=c["n_colors"], proposal=JKind.STANDARD, tailcut=True)
    assert c["sequential_standard"] == mod.cell(lambda: JSeq(jg, jp), jg, 0.04, 2)
    assert c["n_colors"] == max(2, int(jg.max_degree / 2.0))
    assert all(c["checks"].values())
    assert c["variant_effect"]["separates"] and c["variants_separate"]


def test_validate_matrix_runs_past_the_reference_name_error(monkeypatch, tmp_path):
    """The port's full loop at n = 150, 1 seed writes the matrix (JAX's
    raises NameError after its first cell: ``main`` prints ``s`` and
    ``d``, which it never binds)."""
    out, plot = tmp_path / "m.json", tmp_path / "m.png"
    vm.main(["--n", "150", "--seeds", "1", "--device", "cpu", "--out", str(out),
             "--plot", str(plot)])
    matrix = json.loads(out.read_text())
    assert len(matrix["cells"]) == 15 and "partial" not in matrix
    assert "all_checks_pass" in matrix and not Path(str(out) + ".partial").exists()
    mod = load_jax_script("validate_matrix", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["validate_matrix.py", "--n", "150", "--seeds", "1",
                                      "--out", str(tmp_path / "jax.json"),
                                      "--plot", str(tmp_path / "jax.png")])
    with pytest.raises(NameError, match="'s'"):
        mod.main()


def test_run_baseline_small_subprocess(tmp_path):
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "mcmc_colorer_tpu_torch.scripts.run_baseline_configs",
         "--small", "--device", "cpu", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(out.read_text())
    assert report["device"] == "cpu" and report["torch"] == torch.__version__
    assert set(report) == {"device", "torch", "config1_sequential", "config2_luby",
                           "config3_ratio_sweep", "config4_real_world_converted",
                           "config4b_reddit_converted", "config5_ensemble"}
    valids = [report[k]["valid"] for k in report if k.startswith("config")
              and "valid" in report[k]]
    valids += [e["valid"] for e in report["config3_ratio_sweep"]["sweep"].values()]
    assert len(valids) == 8 and all(v is True for v in valids)
    assert set(report["config2_luby"]) == {"n", "m", "valid", "colors", "seconds_setup",
                                           "seconds_total", "seconds_compile",
                                           "seconds_steady"}
    assert set(report["config3_ratio_sweep"]["sweep"]) == {"1.0", "2.0", "4.0"}
    assert report["config5_ensemble"]["chains"] == 8


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
@pytest.mark.parametrize("name", SCRIPTS)
def test_scripts_refuse_without_a_card(name, tmp_path):
    mod = {"run_baseline_configs": rbc, "validate_stats": vs, "validate_matrix": vm}[name]
    out = tmp_path / "out.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--out", str(out)])
    assert not out.exists()


def test_scripts_import_no_jax_and_write_under_build():
    code = ("import sys\n"
            + "".join(f"import mcmc_colorer_tpu_torch.scripts.{s}\n" for s in SCRIPTS)
            + "assert not [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "            or m.startswith('mcmc_colorer_tpu.')], sorted(sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert BUILD_DIR == ROOT / "build"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    for mod, name in ((rbc, "torch_baseline_report.json"), (vs, "torch_validate_stats.json"),
                      (vm, "torch_validate_matrix.json")):
        assert f"BUILD_DIR / \"{name}\"" in Path(mod.__file__).read_text()
    assert 'BUILD_DIR / "torch_validate_matrix_3d.png"' in Path(vm.__file__).read_text()
