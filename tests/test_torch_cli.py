"""The port's command-line interface (``mcmc_colorer_tpu_torch/cli.py``).

Ports of the JAX CLI's tests (``tests/test_cli_analysis.py``), run with
``--device cpu``; the refusal of a mesh larger than the world (exit 2,
naming ``torchrun``) and the JAX CLI's own refusals; the
refusal to run without a card unless asked for the CPU; and the JAX
package's ``log_parser`` reading the port's logs with the same fields
as the JAX CLI's.
"""

import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.analysis.log_parser import parse_results_dir, speedups
from mcmc_colorer_tpu.cli import main as jax_main

from mcmc_colorer_tpu_torch.cli import dataset_gen_main
from mcmc_colorer_tpu_torch.cli import main as cli_main
from mcmc_colorer_tpu_torch.ops import hashgen

torch.set_num_threads(2)

CPU = ["--device", "cpu"]
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_trace(monkeypatch):
    # -v >= 1 sets MCMC_COLORER_TRACE in the process environment; setenv
    # (not delenv of an absent name) makes monkeypatch remove it afterwards
    monkeypatch.setenv("MCMC_COLORER_TRACE", "0")


def test_cli_simulate_all_algos(tmp_path):
    out = tmp_path / "out"
    rc = cli_main(
        [
            "--simulate", "0.1", "-n", "120",
            "--mcmcgpu", "--mcmccpu", "--lubygpu", "--grdffgpu", "--vffgpu",
            "--seed", "7", "--tailcut", "--check", "--quiet", "--outDir", str(out),
            *CPU,
        ]
    )
    assert rc == 0
    logs = sorted(os.listdir(out))
    tags = {f.split("-")[-2] for f in logs if f.endswith(".log")}
    assert tags == {"MCMC_GPU", "MCMC_CPU", "LUBY", "GFF", "VFF"}
    colors = [f for f in logs if f.endswith("-colors.txt")]
    assert len(colors) == 5
    for cf in colors:
        lines = (out / cf).read_text().strip().split("\n")
        assert len(lines) == 120 and lines[0].startswith("0 ")
    # the reference's own device tag pairs in the analysis
    sp = speedups(parse_results_dir(str(out)))
    assert {"MCMC_CPU/MCMC_GPU", "LUBY/MCMC_GPU"} <= set(sp)


def test_cli_errors():
    for argv in (
        ["--simulate", "1.5", "-n", "10", "--quiet"],
        ["--simulate", "0.5", "--quiet"],  # missing -n
        ["--quiet"],  # neither graph nor simulate
    ):
        with pytest.raises(SystemExit) as e:
            cli_main(argv + CPU)
        assert e.value.code == 2


def test_dataset_gen_and_graph_input(tmp_path):
    ds = tmp_path / "g.txt"
    assert dataset_gen_main(["150", "0.05", str(ds), "5"]) == 0
    assert dataset_gen_main(["150"]) == 2
    out = tmp_path / "out"
    rc = cli_main(
        ["--graph", str(ds), "--lubygpu", "--seed", "1", "--check", "--quiet",
         "--outDir", str(out), *CPU]
    )
    assert rc == 0
    assert (out / "g-LUBY-0.log").exists()


def test_cli_greedycpu(tmp_path):
    out = tmp_path / "out"
    rc = cli_main(
        ["--simulate", "0.1", "-n", "100", "--greedycpu", "--seed", "5", "--check",
         "--quiet", "--outDir", str(out), *CPU]
    )
    assert rc == 0
    logs = [f for f in os.listdir(out) if f.endswith(".log")]
    assert any("GREEDY_CPU" in f for f in logs)


def test_cli_resident_luby(tmp_path):
    out = tmp_path / "out"
    rc = cli_main(
        ["--simulate", "0.05", "-n", "600", "--lubygpu", "--resident", "--seed", "2",
         "--check", "--quiet", "--outDir", str(out), *CPU]
    )
    assert rc == 0
    assert (out / "600_0.05_1.0-LUBY-0.log").exists()
    with pytest.raises(SystemExit) as e:  # no mesh for resident Luby
        cli_main(["--simulate", "0.05", "-n", "100", "--lubygpu", "--resident",
                  "--mesh-shards", "2", "--quiet", *CPU])
    assert e.value.code == 2


def test_cli_resident_runs_and_validates(tmp_path):
    out = tmp_path / "out"
    rc = cli_main(
        ["--simulate", "0.04", "-n", "900", "--mcmcgpu", "--resident", "--tailcut",
         "--seed", "11", "--check", "--quiet", "--outDir", str(out), *CPU]
    )
    assert rc == 0
    logs = sorted(os.listdir(out))
    log = [f for f in logs if f.endswith(".log")][0]
    text = (out / log).read_text()
    assert "Nodes: 900" in text
    assert "Execution time:" in text
    assert "Iteration performed:" in text
    assert "-MCMC_GPU-0.log" in log
    cf = [f for f in logs if f.endswith("-colors.txt")][0]
    assert len((out / cf).read_text().strip().split("\n")) == 900


def _past_the_packed_cap(monkeypatch, n_max=512):
    """Lower the packed adjacency's cap, so a small graph takes the route
    of one too large for it."""
    from mcmc_colorer_tpu_torch.models import mcmc_resident

    monkeypatch.setattr(mcmc_resident, "PACKED_ADJ_MAX_N", n_max)


def test_cli_resident_ell_route(tmp_path, capsys, monkeypatch):
    """Past the packed adjacency's cap, --resident --mcmcgpu --backend
    pallas runs MCMCColorer over a HashGraph (its ELL from K5's plain
    version on the CPU), one chain, checked against the host's
    enumeration of the same graph; the colours are MCMCColorer's over
    that HashGraph.  With --layout bucketed it exits 2."""
    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.graph.container import HashGraph
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer

    _past_the_packed_cap(monkeypatch)
    out = tmp_path / "out"
    rc = cli_main(
        ["--simulate", "0.03", "-n", "800", "--mcmcgpu", "--resident", "--backend", "pallas",
         "--tailcut", "--seed", "11", "--check", "--outDir", str(out), *CPU]
    )
    assert rc == 0
    text = capsys.readouterr()
    assert "Resident ELL built" in text.out and "VALID" in text.out
    assert "ignoring --backend" not in text.err
    cf = [f for f in os.listdir(out) if f.endswith("-colors.txt")]
    assert len(cf) == 1 and "-MCMC_GPU-0" in cf[0]
    got = [int(x.split()[1]) for x in (out / cf[0]).read_text().strip().split("\n")]
    from mcmc_colorer_tpu_torch.cli import build_parser

    a = build_parser().parse_args(["--simulate", "0.03", "-n", "800", "--tailcut"])
    hg = HashGraph(800, 0.03, 11, device="cpu")
    params = MCMCParams(n_colors=hg.max_degree, taboo_iterations=a.taboo_iterations,
                        tailcut=True, proposal=ProposalKind(a.proposal),
                        seq_stall_escape=a.seq_stall_escape)
    want = MCMCColorer(hg, params, device="cpu").run(11, 0).colors
    assert got == want.tolist()
    with pytest.raises(SystemExit) as e:
        cli_main(["--simulate", "0.03", "-n", "800", "--mcmcgpu", "--resident", "--backend",
                  "pallas", "--layout", "bucketed", "--quiet", *CPU])
    assert e.value.code == 2


@pytest.mark.parametrize("extra", [["--active"], ["--chains", "2"]], ids=["active", "chains"])
def test_cli_resident_ell_route_refuses_what_it_cannot_run(monkeypatch, capsys, extra):
    """The ELL route runs one chain of full sweeps: --active and --chains
    exit 2 with a message, and are not run on another route."""
    _past_the_packed_cap(monkeypatch)
    with pytest.raises(SystemExit) as e:
        cli_main(["--simulate", "0.03", "-n", "800", "--mcmcgpu", "--resident", "--backend",
                  "pallas", "--quiet", *extra, *CPU])
    assert e.value.code == 2 and f"drop {extra[0]}" in capsys.readouterr().err


def test_cli_resident_backend_below_the_packed_cap(tmp_path, capsys):
    """Where the packed adjacency fits, --resident --backend pallas runs
    the packed resident chain, as it always has, the backend ignored with
    a message."""
    rc = cli_main(["--simulate", "0.03", "-n", "800", "--mcmcgpu", "--resident", "--backend",
                   "pallas", "--seed", "11", "--outDir", str(tmp_path / "out"), *CPU])
    text = capsys.readouterr()
    assert rc == 0 and "ignoring --backend pallas" in text.err
    assert "Resident graph materialised" in text.out and "Resident ELL" not in text.out


def test_cli_resident_mcmc_and_luby_share_adjacency(tmp_path, monkeypatch):
    """--resident --mcmcgpu --lubygpu builds A once: both colorers take
    it from the one cache slot."""
    builds = []
    build = hashgen.er_packed_and_degrees  # the cache's builder: A and its degrees
    monkeypatch.setattr(hashgen, "_PACKED_CACHE", {})
    monkeypatch.setattr(hashgen, "er_packed_and_degrees",
                        lambda *a, **k: builds.append(a) or build(*a, **k))
    out = tmp_path / "out"
    rc = cli_main(
        ["--simulate", "0.05", "-n", "500", "--mcmcgpu", "--lubygpu", "--resident",
         "--tailcut", "--seed", "4", "--check", "--quiet", "--outDir", str(out), *CPU]
    )
    assert rc == 0
    assert len(builds) == 1 and builds[0][:3] == (500, 0.05, 4)
    tags = {f.split("-")[-2] for f in os.listdir(out) if f.endswith(".log")}
    assert tags == {"MCMC_GPU", "LUBY"}


def test_cli_resident_errors():
    for argv in (
        ["--resident", "--mcmcgpu", "--quiet", "-n", "100"],
        ["--resident", "--graph", "x.txt", "--mcmcgpu", "--quiet"],  # needs --simulate
        ["--resident", "--simulate", "0.1", "-n", "60", "--grdffgpu", "--quiet"],
        ["--resident", "--simulate", "0.1", "-n", "60", "--mcmcgpu", "--dbg", "--quiet"],
    ):
        with pytest.raises(SystemExit) as e:
            cli_main(argv + CPU)
        assert e.value.code == 2


# every path of the JAX CLI is ported; a mesh larger than the world (one
# process here) names torchrun, which starts the ranks
UNPORTED = {
    "mesh_chains": (["--mcmcgpu", "--mesh-chains", "2"], "torchrun --nproc-per-node 2"),
    "mesh_shards": (["--mcmcgpu", "--mesh-shards", "2"], "torchrun --nproc-per-node 2"),
    "resident_mesh_shards": (["--mcmcgpu", "--resident", "--mesh-shards", "2"],
                             "torchrun --nproc-per-node 2"),
}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_flags_exit_2(tmp_path, capsys, case):
    flags, msg = UNPORTED[case]
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as e:
        cli_main(["--simulate", "0.1", "-n", "60", "--quiet", "--outDir", str(out),
                  *flags, *CPU])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err
    assert not out.exists()


# the flag sets that exited 2 until the frontier chain, the packed backend
# over a host graph, the bucketed layout, the ensembles, the debugger,
# checkpoints, TRACE, the sharded colorer (frontier ensembles on a 1x1
# mesh, annealing, a one-rank mesh, its checkpoints) and its adjacency
# strips (the matmul/packed backend on every sharded route, the resident
# hash strips on a one-rank mesh; more ranks in
# tests/test_torch_sharded_ranks.py) were ported; Luby ignores --backend,
# as in JAX, and MCMCColorer ignores --ckpt with a message, as in JAX
PORTED = {
    "layout_bucketed": (["--grdffgpu", "--layout", "bucketed"], {"GFF"}),
    "backend_matmul": (["--mcmcgpu", "--backend", "matmul"], {"MCMC_GPU"}),
    "backend_packed_luby": (["--lubygpu", "--backend", "packed"], {"LUBY"}),
    "mcmc_active": (["--mcmcgpu", "--active"], {"MCMC_GPU"}),
    "resident_mcmc_active": (["--mcmcgpu", "--active", "--resident"], {"MCMC_GPU"}),
    "chains": (["--mcmcgpu", "--chains", "2"], {"MCMC_GPU"}),
    "dbg": (["--mcmcgpu", "--dbg"], {"MCMC_GPU"}),
    "ckpt": (["--mcmcgpu", "--ckpt", "run.npz"], {"MCMC_GPU"}),
    "trace": (["--mcmcgpu", "-v", "1"], {"MCMC_GPU"}),
    "resident_trace": (["--mcmcgpu", "--resident", "-v", "2"], {"MCMC_GPU"}),
    "resident_chains_ckpt": (["--mcmcgpu", "--resident", "--chains", "2", "--ckpt", "e.npz"],
                             {"MCMC_GPU"}),
    "active_chains": (["--mcmcgpu", "--active", "--chains", "2"], {"MCMC_GPU"}),
    "anneal": (["--mcmcgpu", "--active", "--chains", "2", "--anneal"], {"MCMC_GPU"}),
    "mesh_one_rank": (["--mcmcgpu", "--mesh-shards", "1", "--chains", "2", "--ckpt", "m.npz"],
                      {"MCMC_GPU"}),
    "mesh_backend_matmul": (["--mcmcgpu", "--mesh-shards", "1", "--backend", "matmul"],
                            {"MCMC_GPU"}),
    "active_chains_backend_packed": (["--mcmcgpu", "--active", "--chains", "2", "--backend",
                                      "packed"], {"MCMC_GPU"}),
    "resident_mesh": (["--mcmcgpu", "--resident", "--mesh-shards", "1", "--chains", "2"],
                      {"MCMC_GPU"}),
    "resident_mesh_active_ckpt": (["--mcmcgpu", "--resident", "--mesh-chains", "1", "--active",
                                   "--anneal", "--ckpt", "r.npz"], {"MCMC_GPU"}),
}


@pytest.mark.parametrize("case", list(PORTED))
def test_ported_flags_run(tmp_path, monkeypatch, case):
    """Each runs with --check --tailcut to a valid colouring, and JAX's
    log_parser reads its log with the reference's fields.  (Checkpoint
    paths are relative to the working directory, a temporary one.)"""
    monkeypatch.chdir(tmp_path)
    flags, tags = PORTED[case]
    out = tmp_path / "out"
    rc = cli_main(["--simulate", "0.1", "-n", "60", "--quiet", "--outDir", str(out),
                   "--seed", "3", "--check", "--tailcut", *flags, *CPU])
    assert rc == 0
    got = parse_results_dir(str(out))
    assert set(got) == tags
    for runs in got.values():
        assert len(runs) == 1
        assert {"execution_time_s", "histogram", "balancing_index"} <= set(runs[0])
        assert runs[0]["used_colors"] > 0


REFUSED = {
    "resume_without_checkpoints": (["--mcmcgpu", "--resume", "run.npz"],
                                   "refusing to restart silently"),
    "active_hastings": (["--mcmcgpu", "--active", "--hastings"], "--hastings"),
    "resident_active_ckpt": (["--mcmcgpu", "--active", "--resident", "--ckpt", "x.npz"],
                             "does not checkpoint"),
    "resident_active_chains": (["--mcmcgpu", "--active", "--resident", "--chains", "2"],
                               "single-chain"),
    "resident_luby_mesh": (["--mcmcgpu", "--lubygpu", "--resident", "--mesh-shards", "1"],
                           "(no mesh)"),
    "resident_anneal": (["--mcmcgpu", "--resident", "--anneal"], "--anneal without a mesh"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_frontier_refusals_exit_2(tmp_path, capsys, case):
    """The JAX CLI's refusals around --active and --resident (cli.py:291-327,
    344-350) and of --resume where nothing checkpoints (cli.py:676-700)."""
    flags, msg = REFUSED[case]
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as e:
        cli_main(["--simulate", "0.1", "-n", "60", "--quiet", "--outDir", str(out),
                  *flags, *CPU])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err
    assert not out.exists()


def test_cli_refuses_without_card(tmp_path, capsys, monkeypatch):
    """Without a card and without --device cpu the CLI exits non-zero
    and runs nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    for extra in ([], ["--device", "cuda"], ["--device", "cuda:0"]):
        with pytest.raises(SystemExit) as e:
            cli_main(["--simulate", "0.1", "-n", "60", "--grdffgpu", "--quiet",
                      "--outDir", str(out), *extra])
        assert e.value.code == 2
        assert "device='cpu'" in capsys.readouterr().err
    assert not out.exists()


def test_cli_active_colorers(tmp_path):
    out = tmp_path / "out"
    rc = cli_main(
        ["--simulate", "0.1", "-n", "150", "--lubygpu", "--grdffgpu", "--vffgpu",
         "--active", "--seed", "3", "--check", "--quiet", "--outDir", str(out), *CPU]
    )
    assert rc == 0
    tags = {f.split("-")[-2] for f in os.listdir(out) if f.endswith(".log")}
    assert tags == {"LUBY", "GFF", "VFF"}


def test_cli_trace_and_reference_flags(tmp_path, capsys):
    """-v clamps with the reference's warning and turns TRACE on (the
    histogram goes to stderr); --cite-me prints the BibTeX entry."""
    assert cli_main(["--cite-me"]) == 0
    assert "@inproceedings{colorerGbR2019" in capsys.readouterr().out
    out = tmp_path / "out"
    rc = cli_main(
        ["-s", "0.1", "-n", "80", "-4", "-v", "5", "-S", "42", "--check", "--quiet",
         "-o", str(out), *CPU]
    )
    assert rc == 0
    err = capsys.readouterr().err
    assert "verbose-level higher than 3." in err
    assert "Every * is" in err
    assert list(out.glob("*-GFF-0-colors.txt"))


@pytest.mark.parametrize("active", [False, True])
def test_log_parser_reads_port_logs(tmp_path, active):
    """JAX's parse_results_dir reads the port's logs; for the
    deterministic colorers every field but the time equals the JAX CLI's
    on the same graph."""
    argv = ["--simulate", "0.1", "-n", "120", "--grdffgpu", "--vffgpu", "--seed", "7",
            "--repet", "2", "--quiet"] + (["--active"] if active else [])
    assert jax_main(argv + ["--outDir", str(tmp_path / "jax")]) == 0
    assert cli_main(argv + ["--outDir", str(tmp_path / "port"), *CPU]) == 0
    want = parse_results_dir(str(tmp_path / "jax"))
    got = parse_results_dir(str(tmp_path / "port"))
    assert set(got) == set(want) == {"GFF", "VFF"}
    for tag in want:
        a = sorted(got[tag], key=lambda r: r["repetition"])
        b = sorted(want[tag], key=lambda r: r["repetition"])
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            assert "execution_time_s" in x and "histogram" in x and "balancing_index" in x
            for k in x:
                if k not in ("path", "execution_time_s"):
                    assert x[k] == y[k], (tag, k)
    for f in (tmp_path / "port").glob("*-colors.txt"):
        twin = tmp_path / "jax" / f.name
        assert np.array_equal(np.loadtxt(f), np.loadtxt(twin))


def test_cli_module_entry(tmp_path):
    """``python -m mcmc_colorer_tpu_torch.cli`` runs main and exits with
    its code."""
    out = tmp_path / "out"
    env = {k: v for k, v in os.environ.items() if k != "MCMC_COLORER_TRACE"}
    proc = subprocess.run(
        [sys.executable, "-m", "mcmc_colorer_tpu_torch.cli", "--simulate", "0.1", "-n",
         "80", "--grdffgpu", "--seed", "2", "--check", "--outDir", str(out), *CPU],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "GFF rep 0" in proc.stdout and "VALID" in proc.stdout
    assert list(out.glob("*-GFF-0.log"))


@pytest.mark.parametrize("flags", [["--resident", "--chains", "3"], ["--resident"], ["--dbg"]],
                         ids=["resident_ensemble", "resident", "stepped"])
def test_cli_checkpoint_then_resume(tmp_path, monkeypatch, flags):
    """--ckpt writes the chain's checkpoint at each segment boundary, and a
    second call with --resume continues it to the same colouring."""
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    ck = str(tmp_path / "chain.npz")
    # numColRatio 2: the chain needs sweeps, so a segment boundary comes
    base = ["--simulate", "0.1", "-n", "150", "--mcmcgpu", "--seed", "4", "-r", "2",
            "--tailcut", "--check", "--quiet", *flags, *CPU]
    assert cli_main(base + ["--ckpt", ck, "--outDir", str(tmp_path / "a")]) == 0
    assert os.path.exists(ck)
    assert cli_main(base + ["--resume", ck, "--outDir", str(tmp_path / "b")]) == 0
    (a,) = (tmp_path / "a").glob("*-colors.txt")
    (b,) = (tmp_path / "b").glob("*-colors.txt")
    assert a.read_text() == b.read_text()
