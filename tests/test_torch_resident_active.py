"""The resident frontier chain (``ResidentMCMCColorer(active=True)``)
against the JAX package's (``tests/test_resident_active.py``), on the CPU.

- ``packed_rows_to_ids`` (frontier rows unpacked from the packed A)
  equals the host ELL's sorted rows and JAX's unpack, exactly, in one row
  block and in many.
- The frontier iteration with rows from the packed A equals the one with
  rows from the host ELL on the same draws (the two row sources are
  interchangeable), and JAX's ``_active_iteration(adj_packed=...)`` on
  JAX's draws under the rule of ``tests/test_torch_active.py``.
- Whole runs (the port's own draws): valid, the JAX refusals, a cap exit
  reporting its real conflicts, and the switch tested only between
  budgets of 4 full sweeps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.config import MCMCParams as JParams
from mcmc_colorer_tpu.config import ProposalKind as JKind
from mcmc_colorer_tpu.models import mcmc_active as ja
from mcmc_colorer_tpu.models.mcmc_resident import ResidentMCMCColorer as JResident
from mcmc_colorer_tpu.ops.dense_adj import packed_rows_to_ids as j_rows_to_ids

from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.models import mcmc_active as ta
from mcmc_colorer_tpu_torch.models.base import check_coloring
from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer
from mcmc_colorer_tpu_torch.ops import dense_adj as td
from mcmc_colorer_tpu_torch.ops import packed_nc as k1
from mcmc_colorer_tpu_torch.ops import resample as k2

from test_torch_active import Recorder, Replay, active_draws, check_iteration, t
from test_torch_mcmc import jax_cdf, port_params

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def res700():
    """The port's resident colorer of JAX's test graph, its host ELL at
    the same n_pad, and its d_row."""
    c = ResidentMCMCColorer(700, 0.05, graph_seed=11, device="cpu")
    g = c.host_graph()
    return c, g, g.to_ell(pad_nodes_to=c.n_pad, pad_degree_to=8, device="cpu"), c.d_row


@pytest.mark.parametrize("blocks", ["one", "many"])
def test_packed_rows_to_ids_matches_host_ell(res700, monkeypatch, blocks):
    """Mirrors test_packed_rows_to_ids_matches_host_ell: the unpacked rows
    equal the sorted host ELL rows and JAX's unpack of JAX's A."""
    c, g, ell, d_row = res700
    if blocks == "many":  # row blocks of 8
        monkeypatch.setattr(td, "ROWS_TO_IDS_BLOCK_BYTES", 8 * c.adj.shape[1] * 32 * 4)
    ids = torch.tensor([0, 3, 17, 699, 256, 698, 1, 2, 5, 9, 100], dtype=torch.int32)
    rows = td.packed_rows_to_ids(c.adj.index_select(0, ids), d_row, c.n_pad)
    host = np.sort(ell.neighbors.numpy()[ids.numpy()], axis=1)[:, :d_row]
    assert np.array_equal(rows.numpy(), host)
    j = JResident(700, 0.05, graph_seed=11)
    want = j_rows_to_ids(jnp.take(j.adj, jnp.asarray(ids.numpy()), axis=0), d_row, c.n_pad)
    assert np.array_equal(rows.numpy(), np.asarray(want))
    assert d_row == ((j.max_degree + 7) // 8) * 8


def _state(c, n_colors, seed):
    rng = np.random.default_rng(seed)
    colors = rng.integers(0, n_colors, c.n_pad).astype(np.int32)
    colors[c.n:] = n_colors
    taboo = rng.integers(0, 3, c.n_pad).astype(np.int32)
    taboo[c.n:] = 0
    return colors, taboo


def test_active_iteration_rows_from_packed_equal_ell_rows(res700):
    """Mirrors test_active_iteration_bit_matches_ell_rows: the frontier
    iteration over ``PackedRows`` equals it over the host ELL, on the
    same draws, exactly; K1's plain version counts cnt as the ELL does."""
    c, g, ell, d_row = res700
    params = MCMCParams(n_colors=max(4, c.max_degree // 2),
                        proposal=ProposalKind.BALANCE_DYNAMIC, taboo_iterations=2)
    colors, taboo = _state(c, params.n_colors, 7)
    packed = ta.PackedRows(c.adj, d_row, c.n, c.node_mask)
    cnt = ta._cnt_of(ell, t(colors))
    assert torch.equal(cnt, ta._cnt_of_packed(c.adj, t(colors), params=params,
                                              node_mask=c.node_mask))
    draws = active_draws(jax.random.key(7), 256, c.n_pad, params.n_colors)
    a = ta._active_iteration(ell, t(colors), t(taboo), cnt, Replay(draws), cap=256,
                             params=params, backend="pallas")
    b = ta._active_iteration(packed, t(colors), t(taboo), cnt, Replay(draws), cap=256,
                             params=params, backend="pallas")
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    assert a[3] == b[3]


def test_resident_active_iteration_matches_jax(res700):
    """JAX's resident frontier iteration (rows from its packed A) on its
    draws against the port's over ``PackedRows``."""
    c, g, ell, d_row = res700
    j = JResident(700, 0.05, graph_seed=11)
    n_colors = max(4, c.max_degree // 2)
    jp = JParams(n_colors=n_colors, proposal=JKind.BALANCE_DYNAMIC, taboo_iterations=2)
    pt = port_params(jp)
    colors, taboo = _state(c, n_colors, 3)
    cnt = np.asarray(ja._cnt_of_packed(j.adj, jnp.asarray(colors), params=jp,
                                       node_mask=j.ell.node_mask))
    mask = np.arange(c.n_pad) < c.n
    n_active = int(((cnt > 0) & (taboo == 0) & mask).sum())
    cap = ja.pick_cap(ja._buckets(c.n_pad), n_active)
    k_it = jax.random.key(4)
    draws = active_draws(k_it, cap, c.n_pad, n_colors)
    want = ja._active_iteration(j.ell, jnp.asarray(colors), jnp.asarray(taboo),
                                jnp.asarray(cnt), k_it, cap=cap, params=jp, backend="xla",
                                adj_packed=j.adj, d_row=d_row)
    packed = ta.PackedRows(c.adj, d_row, c.n, c.node_mask)
    got = ta._active_iteration(packed, t(colors), t(taboo), t(cnt), Replay(draws), cap=cap,
                               params=pt, backend="pallas")
    ids = np.flatnonzero((cnt > 0) & (taboo == 0) & mask)
    unif_full = np.zeros(c.n_pad, np.float32)
    unif_full[ids] = draws[0][: ids.size]
    je = interop_jax_ell(g, c.n_pad)
    check_iteration(got, want, colors, unif_full, jax_cdf(je, jnp.asarray(colors), jp), c.n,
                    ell)


def interop_jax_ell(g, n_pad):
    """JAX's ELL of the port's host graph (the same CSR)."""
    from mcmc_colorer_tpu.graph.container import Graph as JGraph

    return JGraph(n=g.n, row_ptr=g.row_ptr, cols=g.cols).to_ell(pad_nodes_to=n_pad)


def test_resident_active_end_to_end_valid():
    """Mirrors test_resident_active_end_to_end_valid."""
    p0 = ResidentMCMCColorer(1200, 0.04, graph_seed=21, device="cpu")
    params = MCMCParams(n_colors=max(4, p0.max_degree * 2 // 3),
                        proposal=ProposalKind.BALANCE_DYNAMIC, tailcut=True, max_iterations=80)
    c = ResidentMCMCColorer(1200, 0.04, graph_seed=21, params=params, active=True, device="cpu")
    before = (k1.launches, k2.launches)
    r = c.run(seed=5)
    assert (k1.launches, k2.launches) == before  # CPU: the plain versions
    assert r.extra["active"] is True
    assert r.extra["final_conflicts"] == 0
    assert check_coloring(c.host_graph(), r.colors)


def test_resident_active_rejects_ensemble_hastings_checkpoints():
    with pytest.raises(NotImplementedError, match="single-chain"):
        ResidentMCMCColorer(600, 0.05, graph_seed=9, n_chains=2, active=True, device="cpu")
    with pytest.raises(NotImplementedError, match="always-accept"):
        ResidentMCMCColorer(600, 0.05, graph_seed=9, active=True, device="cpu",
                            params=MCMCParams(n_colors=40, hastings=True))
    c = ResidentMCMCColorer(600, 0.05, graph_seed=9, active=True, device="cpu")
    with pytest.raises(NotImplementedError, match="checkpointing"):
        c.run(seed=1, checkpoint_path="x")


def test_resident_active_cap_exit_reports_real_conflicts():
    """Mirrors test_resident_active_cap_exit_reports_real_conflicts."""
    c = ResidentMCMCColorer(
        400, 0.2, graph_seed=5,
        params=MCMCParams(n_colors=3, tailcut=False, max_iterations=3),
        active=True, device="cpu",
    )
    r = c.run(seed=1)
    g = c.host_graph()
    assert r.extra["final_conflicts"] > 0 and not r.converged
    assert not check_coloring(g, r.colors)
    assert all(x >= 0 for x in r.conflict_trace)
    c2 = ResidentMCMCColorer(
        400, 0.2, graph_seed=5,
        params=MCMCParams(n_colors=c.max_degree, tailcut=True, max_iterations=2),
        active=True, device="cpu",
    )
    r2 = c2.run(seed=1)
    assert r2.extra["tailcut_rounds"] >= 1
    assert r2.extra["final_conflicts"] == 0
    assert check_coloring(g, r2.colors)


def test_resident_switch_between_budgets():
    """Phase 1 runs full sweeps in budgets of 4 and tests the switch only
    at their ends, on the last body's conflicts (mcmc_resident.py:427-438);
    then 4 draws a frontier iteration."""
    p0 = ResidentMCMCColorer(1200, 0.04, graph_seed=21, device="cpu")
    params = MCMCParams(n_colors=max(4, p0.max_degree * 2 // 3),
                        proposal=ProposalKind.BALANCE_DYNAMIC, max_iterations=40)
    c = ResidentMCMCColorer(1200, 0.04, graph_seed=21, params=params, active=True, device="cpu")
    src = Recorder(3)
    r = c.run(seed=3, source=src)
    x, trace, n_pad = r.extra, r.conflict_trace, c.n_pad
    switch = x["switch_iteration"]
    assert switch is not None and switch % 4 == 0 and x["sweeps"] == switch
    assert 2 * trace[switch - 1] < n_pad // 8
    assert all(2 * trace[k - 1] >= n_pad // 8 for k in range(4, switch, 4))
    frontier = sum(x["frontier_iterations"].values())
    assert frontier > 0 and r.iterations == switch + frontier
    assert src.log[: switch + 1] == [("next", n_pad)] * (switch + 1)
    rest = src.log[switch + 1:]
    assert len(rest) == 4 * frontier
    assert all(rest[4 * i + 1:4 * i + 4] == [("next", 1), ("randint", 1), ("randint", 1)]
               for i in range(frontier))
    # the trace: the full sweeps' counts, then one a frontier state
    assert len(trace) == switch + frontier + 1 and trace[-1] == x["final_conflicts"]
