"""The port's public API against the JAX package's, on the CPU.

- ``ops/hashgen.hash_er_graph`` behind the three ``host_graph()`` sites
  (the resident chain, resident Luby, the sharded colorer's
  ``resident_spec`` on a 1x1 mesh): certified simple as JAX's, the CSR
  equal to JAX's ``host_graph()`` and to ``hash_edges_reference``'s edges
  (exact).
- ``graph/native.run_mcmc_seq`` and ``available``: the same C++ chain as
  JAX's, so colours and iterations are equal (exact).
- ``config.RunConfig`` (JAX's ``tests/test_config.py:38-48`` cases, field
  by field), the package exports, ``utils/memtrack.estimate_run_bytes``
  and ``EllGraph.neighbor_mask``: equal to JAX's (exact).
"""

import dataclasses
import enum
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import mcmc_colorer_tpu
import mcmc_colorer_tpu_torch
from mcmc_colorer_tpu.config import MCMCParams as JParams
from mcmc_colorer_tpu.config import RunConfig as JRunConfig
from mcmc_colorer_tpu.graph import native as jnative
from mcmc_colorer_tpu.graph.generate import erdos_renyi as j_er
from mcmc_colorer_tpu.ops.hashgen import hash_er_graph as j_hash_er_graph
from mcmc_colorer_tpu.utils.memtrack import estimate_run_bytes as j_estimate

from mcmc_colorer_tpu_torch import interop
from mcmc_colorer_tpu_torch.config import ColorerKind, MCMCParams, ProposalKind, RunConfig
from mcmc_colorer_tpu_torch.graph import native
from mcmc_colorer_tpu_torch.ops.hashgen import hash_edges_reference, hash_er_graph
from mcmc_colorer_tpu_torch.utils.memtrack import estimate_run_bytes

SPEC = (300, 0.05, 7)


def _port_site(site):
    from mcmc_colorer_tpu_torch.models.luby import LubyColorer
    from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer
    from mcmc_colorer_tpu_torch.parallel.mesh import make_mesh
    from mcmc_colorer_tpu_torch.parallel.sharded import ShardedMCMCColorer

    n, p, seed = SPEC
    if site == "resident":
        return ResidentMCMCColorer(n, p, seed, MCMCParams(n_colors=0), device="cpu")
    if site == "luby":
        return LubyColorer(None, resident_spec=SPEC, device="cpu")
    return ShardedMCMCColorer(None, MCMCParams(n_colors=0), make_mesh(1, 1, device="cpu"),
                              resident_spec=SPEC)


def _jax_site(site):
    from mcmc_colorer_tpu.models.luby import LubyColorer
    from mcmc_colorer_tpu.models.mcmc_resident import ResidentMCMCColorer
    from mcmc_colorer_tpu.parallel.mesh import make_mesh
    from mcmc_colorer_tpu.parallel.sharded import ShardedMCMCColorer

    n, p, seed = SPEC
    if site == "resident":
        return ResidentMCMCColorer(n, p, seed, JParams(n_colors=0))
    if site == "luby":
        return LubyColorer(None, resident_spec=SPEC)
    return ShardedMCMCColorer(None, JParams(n_colors=0),
                              make_mesh(1, 1, devices=jax.devices()[:1]), resident_spec=SPEC)


@pytest.mark.parametrize("site", ["resident", "luby", "sharded"])
def test_host_graph_is_certified_simple_as_jax(site):
    got, want = _port_site(site).host_graph(), _jax_site(site).host_graph()
    assert got.simple_certified is True
    assert got.simple_certified == want.simple_certified
    assert got.name == want.name == f"er_hash_{SPEC[0]}_{SPEC[1]}"
    assert got.n == want.n
    assert np.array_equal(got.row_ptr, want.row_ptr)
    assert np.array_equal(got.cols, want.cols)
    edges = hash_edges_reference(*SPEC)
    u = np.repeat(np.arange(got.n), np.diff(got.row_ptr))
    upper = u < got.cols
    assert np.array_equal(np.stack([u[upper], got.cols[upper]], axis=1), edges)
    assert got.n_edges == len(edges)


def test_hash_er_graph_matches_jax():
    got, want = hash_er_graph(*SPEC, name="g"), j_hash_er_graph(*SPEC, name="g")
    assert (got.name, got.simple_certified) == (want.name, want.simple_certified) == ("g", True)
    assert np.array_equal(got.row_ptr, want.row_ptr) and np.array_equal(got.cols, want.cols)
    assert hash_er_graph(*SPEC).name == j_hash_er_graph(*SPEC).name


def test_run_mcmc_seq_matches_jax():
    """Mirrors tests/test_graph.py:258-263: the same library, so exact."""
    assert native.available() and jnative.available()
    jg = j_er(400, 0.1, seed=5)
    g = interop.graph_from_jax(jg)
    want = jnative.run_mcmc_seq(jg, jg.max_degree, max_iterations=250, taboo_iterations=2,
                                seed=3)
    got = native.run_mcmc_seq(g, g.max_degree, max_iterations=250, taboo_iterations=2, seed=3)
    assert got[0].dtype == np.int32 and got[0].shape == (g.n,)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert 0 < got[1] <= 250
    for kw in (dict(epsilon=1e-3, z=5, seed=9), dict(max_iterations=3, seed=1)):
        a = native.run_mcmc_seq(g, g.max_degree // 2, **kw)
        b = jnative.run_mcmc_seq(jg, jg.max_degree // 2, **kw)
        assert np.array_equal(a[0], b[0]) and a[1] == b[1]
    with pytest.raises(ValueError, match="not a CSR"):
        native.run_mcmc_seq(SimpleNamespace(n=g.n + 1, row_ptr=g.row_ptr, cols=g.cols), 4)


def _fields(x) -> dict:
    """A dataclass's fields, enums as their values."""
    return {k: v.value if isinstance(v, enum.Enum) else v
            for k, v in dataclasses.asdict(x).items()}


RUN_CONFIGS = {
    "simulated": dict(simulate_p=0.01, n_nodes=500, num_color_ratio=2.0),
    "file": dict(graph_path="/data/reddit.txt", out_dir="/tmp/o"),
    "no_extension": dict(graph_path="/data/graph"),
    "ratio_above": dict(num_color_ratio=99.0),
    "ratio_below": dict(num_color_ratio=0.1),
    "explicit": dict(n_colors=17, taboo_iterations=3, tailcut=True, hastings=True,
                     proposal="standard", n_chains=4, mesh_chains=2, use_pallas=False),
}


@pytest.mark.parametrize("case", list(RUN_CONFIGS))
def test_run_config_matches_jax(case):
    kw = dict(RUN_CONFIGS[case], seed=11)
    jkw = dict(kw)
    if "proposal" in kw:
        kw["proposal"] = ProposalKind(kw["proposal"])
        jkw["proposal"] = type(JRunConfig().proposal)(jkw["proposal"])
    got, want = RunConfig(**kw), JRunConfig(**jkw)
    assert _fields(got) == _fields(want)
    assert (got.graph_name, got.output_dir) == (want.graph_name, want.output_dir)
    for max_degree in (1, 64, 1150):
        assert _fields(got.mcmc_params(max_degree)) == _fields(want.mcmc_params(max_degree))
    assert isinstance(got.mcmc_params(64), MCMCParams)


def test_run_config_defaults_and_derivations():
    """tests/test_config.py:38-48 on the port."""
    got, want = RunConfig(), JRunConfig()
    assert {k: v for k, v in _fields(got).items() if k != "seed"} == {
        k: v for k, v in _fields(want).items() if k != "seed"}
    assert got.colorer is ColorerKind.MCMC_SEQ and abs(got.seed - want.seed) <= 5
    cfg = RunConfig(simulate_p=0.01, n_nodes=500, num_color_ratio=2.0)
    assert (cfg.graph_name, cfg.output_dir) == ("500_0.01_2.0", "500_0.01_2.0_out")
    assert RunConfig(num_color_ratio=99.0).mcmc_params(max_degree=64).n_colors == 4
    assert RunConfig(num_color_ratio=0.1).mcmc_params(max_degree=64).n_colors == 64


def test_package_exports_match_jax():
    assert mcmc_colorer_tpu_torch.__all__ == mcmc_colorer_tpu.__all__
    assert mcmc_colorer_tpu_torch.__version__ == mcmc_colorer_tpu.__version__
    for name in ("ColorerKind", "ProposalKind", "InitKind"):
        ours, theirs = getattr(mcmc_colorer_tpu_torch, name), getattr(mcmc_colorer_tpu, name)
        assert [(k.name, k.value) for k in ours] == [(k.name, k.value) for k in theirs]
    for name in ("Graph", "Coloring", "MCMCParams", "RunConfig"):
        ours, theirs = getattr(mcmc_colorer_tpu_torch, name), getattr(mcmc_colorer_tpu, name)
        want = [f.name for f in dataclasses.fields(theirs)]
        # the port's Graph also declares JAX's ``simple_certified`` attribute
        assert [f.name for f in dataclasses.fields(ours)][:len(want)] == want, name
    assert "jax" not in mcmc_colorer_tpu_torch.Graph.__module__


@pytest.mark.parametrize("args", [
    (1000, 50, 50), (1000, 50, 50, 256, 1), (100_000, 1150, 1150, 512, 8),
    (1_000_000, 1280, 293, 128, 2), (7, 0, 1, 1, 3),
])
def test_estimate_run_bytes_matches_jax(args):
    assert estimate_run_bytes(*args) == j_estimate(*args)
    est = estimate_run_bytes(*args)
    assert est["reference_colors_checker_bytes"] == args[0] * args[2]


def test_neighbor_mask_matches_jax(medium_er):
    jell = medium_er.to_ell(pad_nodes_to=128, pad_degree_to=8)
    ell = interop.graph_from_jax(medium_er).to_ell(pad_nodes_to=128, pad_degree_to=8,
                                                   device="cpu")
    got = ell.neighbor_mask
    assert got.dtype == torch.bool and got.shape == (ell.n_pad, ell.d_pad)
    assert np.array_equal(got.numpy(), np.asarray(jell.neighbor_mask))
    assert int(got.sum()) == 2 * medium_er.n_edges
