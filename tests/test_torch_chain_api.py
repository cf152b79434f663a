"""The port's stepped chain (``models/chain_api.py``) against the JAX
package's (``mcmc_colorer_tpu/models/chain_api.py``), on the CPU.

- Teacher-forced bodies: from each JAX stepped state, brought over as
  numpy, the port's ``_step_segment`` runs one body on the uniforms JAX's
  ``_step_segment`` drew for it (``k_u``, and ``k_acc`` under Hastings),
  standard, Hastings and with an ε override.  The iteration and the
  conflict count must be equal; colours follow the CDF-boundary rule of
  ``test_torch_resample.py`` (differences only where the uniform lies
  within 1e-5 of a cdf step, at most 0.1 % of vertices) and the taboo is
  equal where the colours agree.
- ``inspect`` on one state, flat and bucketed: integer fields and the
  histogram exact, the average free colours to 1e-6 relative.
- Checkpoints (the port's own chain): a resumed run is bit-equal to the
  uninterrupted one; graph, palette and layout mismatches raise JAX's
  AssertionError; a JAX checkpoint is refused with a ValueError.
- Whole runs on the port's own draws mirror ``tests/test_chain_api.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.config import MCMCParams as JParams
from mcmc_colorer_tpu.config import ProposalKind as JKind
from mcmc_colorer_tpu.models import mcmc as jm
from mcmc_colorer_tpu.models.chain_api import SteppedMCMC as JStepped
from mcmc_colorer_tpu.ops.neighbor import color_histogram as j_hist
from mcmc_colorer_tpu.ops.neighbor import neighbor_colors as j_nc
from mcmc_colorer_tpu.ops.neighbor import occupancy_matrix as j_occ

from mcmc_colorer_tpu_torch import interop
from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.models import chain_api as tapi
from mcmc_colorer_tpu_torch.models import mcmc as tm
from mcmc_colorer_tpu_torch.models.base import check_coloring
from mcmc_colorer_tpu_torch.utils.rng import ChainSources, TorchUniformSource

from test_torch_mcmc import Replay, jax_uniform, port_params
from test_torch_resample import assert_boundary_only

torch.set_num_threads(2)


def stepped(g, params, **kw):
    return tapi.SteppedMCMC(interop.graph_from_jax(g), params, device="cpu", **kw)


def jax_cdf(ell, colors, jp, eps):
    hist = j_hist(colors, jp.n_colors, ell.node_mask)
    p_eff = jm._variant_distribution(jp, hist, ell.n_nodes)
    occ = j_occ(j_nc(ell.neighbors, colors), jp.n_colors)
    q = jm._proposal_q(colors, occ, jp, p_eff, eps=eps)
    return np.asarray(jnp.cumsum(q, axis=1))


STEPS = {
    "standard": dict(proposal=JKind.STANDARD),
    "balance": dict(proposal=JKind.BALANCE_DYNAMIC, taboo_iterations=1),
    "hastings": dict(proposal=JKind.BALANCE_DYNAMIC, hastings=True, lambda_=25.0),
    "epsilon": dict(proposal=JKind.BALANCE_DYNAMIC, eps=True),
}


@pytest.mark.parametrize("case", list(STEPS))
def test_stepped_body_matches_jax(medium_er, case):
    kw = dict(STEPS[case])
    eps = 0.05 / (medium_er.max_degree // 2) if kw.pop("eps", False) else None
    jp = JParams(n_colors=medium_er.max_degree // 2, tailcut=True, **kw)
    ja = JStepped(medium_er, jp)  # 'auto' is XLA's plain sweep on the CPU
    pt = port_params(jp)
    te = interop.graph_from_jax(medium_er).to_ell(pad_nodes_to=ja.block, pad_degree_to=8,
                                                  device="cpu")
    assert te.n_pad == ja.ell.n_pad
    z = jp.tailcut_threshold(medium_er.n)
    st = ja.init_state(seed=4)
    bodies = accepted = 0
    for _ in range(4):
        if int(st.conflicts) <= z:
            break
        _, k_u, k_acc = jax.random.split(st.key, 3)
        unif = jax_uniform(k_u, (te.n_pad,))
        source = Replay([unif.copy()] + ([jax_uniform(k_acc, ())] if jp.hastings else []))
        # the chain core's carry at one chain, without a trace
        carry = tm.ChainState(torch.from_numpy(np.array(st.colors))[None],
                              torch.from_numpy(np.array(st.taboo))[None],
                              np.array([int(st.iteration)]), np.array([int(st.conflicts)]),
                              None, np.zeros(1, bool))
        cdf = jax_cdf(ja.ell, st.colors, jp, None if eps is None else jnp.float32(eps))
        got = tapi._step_segment(te, carry, ChainSources([source], "cpu"), eps, 1, params=pt,
                                 block=ja.block, backend="xla")
        assert not source.draws  # the body drew exactly what JAX's drew
        before = np.asarray(st.colors)
        st = ja.step(st, n_steps=1, epsilon=eps)
        assert (got.rip[0], got.conf_last[0]) == (int(st.iteration), int(st.conflicts))
        mism = assert_boundary_only(got.colors[0].numpy(), np.asarray(st.colors), unif, cdf,
                                    te.n_nodes)
        keep = np.ones(te.n_pad, bool)
        keep[mism] = False
        assert np.array_equal(got.taboo[0].numpy()[keep], np.asarray(st.taboo)[keep])
        accepted += not np.array_equal(np.asarray(st.colors), before)
        bodies += 1
    assert bodies >= 2 and accepted >= 1
    # a converged chain does not step: no draw, no change
    done = tm.ChainState(carry.colors, carry.taboo, np.array([3]), np.array([0]), None,
                         np.zeros(1, bool))
    out = tapi._step_segment(te, done, ChainSources([Replay([])], "cpu"), None, 5, params=pt,
                             block=ja.block, backend="xla")
    assert out.rip[0] == 3 and out.colors is carry.colors


@pytest.mark.parametrize("layout", ["flat", "bucketed"])
def test_inspect_matches_jax(medium_er, layout):
    jp = JParams(n_colors=medium_er.max_degree // 2, taboo_iterations=2)
    ja = JStepped(medium_er, jp, layout=layout)
    st = ja.step(ja.init_state(seed=5), n_steps=2)
    want = ja.inspect(st)
    api = stepped(medium_er, port_params(jp), block_size=ja.block, backend="xla",
                  layout=layout)
    assert api.ell.n_pad == ja.ell.n_pad
    mine = interop.stepped_from_numpy(np.asarray(st.colors), np.asarray(st.taboo),
                                      st.iteration, st.conflicts,
                                      TorchUniformSource(0, 0, "cpu").get_state())
    got = api.inspect(mine)
    assert got.keys() == want.keys()
    for k in want:
        if k == "free_colors_avg":
            assert got[k] == pytest.approx(want[k], rel=1e-6)
        elif k == "histogram":
            assert np.array_equal(got[k], np.asarray(want[k]))
        else:
            assert got[k] == want[k], k
    assert want["violating_nodes"] > 0 and want["taboo_active"] > 0
    back = interop.stepped_to_numpy(mine)
    assert np.array_equal(back["colors"], np.asarray(st.colors))
    assert int(back["iteration"]) == int(st.iteration)


def test_stepping_and_inspection(small_er):
    """Mirrors tests/test_chain_api.py:test_stepping_and_inspection."""
    api = stepped(small_er, MCMCParams(n_colors=small_er.max_degree, taboo_iterations=2))
    st = api.init_state(seed=4)
    info0 = api.inspect(st)
    assert info0["iteration"] == 0 and info0["conflict_edges"] == st.conflicts
    st = api.step(st, n_steps=3)
    info = api.inspect(st)
    assert info["iteration"] <= 3
    assert info["free_colors_min"] <= info["free_colors_avg"] <= info["free_colors_max"]
    assert info["histogram"].sum() == small_er.n
    st = api.step(st, n_steps=500)
    assert st.conflicts == 0
    frozen = api.step(st, n_steps=5)
    assert frozen.iteration == st.iteration
    assert torch.equal(frozen.rng, st.rng)  # a converged chain draws nothing


def test_stepped_run_converges_and_hastings(small_er):
    """Mirrors test_stepped_run_converges and test_stepped_hastings: at
    λ = 1e6 any conflict-increasing sweep is rejected."""
    r = stepped(small_er, MCMCParams(n_colors=small_er.max_degree)).run(seed=9)
    assert r.extra["final_conflicts"] == 0 and check_coloring(
        interop.graph_from_jax(small_er), r.colors)
    p = MCMCParams(n_colors=max(3, small_er.max_degree // 2),
                   proposal=ProposalKind.BALANCE_DYNAMIC, hastings=True, lambda_=1e6,
                   tailcut=True)
    api = stepped(small_er, p)
    st = api.init_state(seed=3)
    prev = st.conflicts
    for _ in range(12):
        st = api.step(st, n_steps=1)
        assert st.conflicts <= prev
        prev = st.conflicts
    r = api.run(seed=9)
    assert r.extra["final_conflicts"] == 0
    assert check_coloring(interop.graph_from_jax(small_er), r.colors)


def test_epsilon_live_edit(small_er):
    """Mirrors test_epsilon_live_edit: a huge ε keeps conflicts high."""
    api = stepped(small_er, MCMCParams(n_colors=small_er.max_degree))
    st = api.init_state(seed=1)
    chaotic = api.step(st, n_steps=5, epsilon=0.9 / api.params.n_colors)
    calm = api.step(st, n_steps=5)
    assert chaotic.conflicts >= calm.conflicts


@pytest.mark.parametrize("layout", ["flat", "bucketed"])
def test_checkpoint_resume_bit_equal(medium_er, tmp_path, layout):
    """A run resumed from a checkpoint of its own chain, written after two
    steps, equals the uninterrupted run bit for bit (the generator state
    travels in the checkpoint)."""
    p = MCMCParams(n_colors=max(4, medium_er.max_degree // 2), tailcut=True)
    ref = stepped(medium_er, p, layout=layout).run(seed=5, segment=1)
    b = stepped(medium_er, p, layout=layout)
    st = b.step(b.init_state(seed=5), n_steps=2)
    ck = str(tmp_path / "ch.npz")
    b.save_checkpoint(st, ck)
    st2 = b.load_checkpoint(ck)
    assert torch.equal(st2.colors, st.colors) and st2.iteration == st.iteration == 2
    a1, a2 = b.step(st, n_steps=1), b.step(st2, n_steps=1)
    assert torch.equal(a1.colors, a2.colors) and a1.conflicts == a2.conflicts
    res = stepped(medium_er, p, layout=layout).run(seed=0, resume_from=ck)
    assert np.array_equal(res.colors, ref.colors)
    assert res.iterations == ref.iterations and res.iterations > 2
    assert res.extra == ref.extra
    assert not list(tmp_path.glob("*.tmp.npz"))  # written, then renamed


def test_checkpoint_each_segment(small_er, tmp_path):
    """``run(checkpoint_path=)`` writes after each segment: the last one
    holds the final chain state."""
    api = stepped(small_er, MCMCParams(n_colors=max(4, small_er.max_degree // 2)))
    ck = str(tmp_path / "seg")
    r = api.run(seed=2, segment=1, checkpoint_path=ck)
    st = api.load_checkpoint(ck)  # ".npz" appended, as JAX does
    assert st.iteration == r.iterations


def test_checkpoint_mismatches(small_er, medium_er, tmp_path):
    """Graph, palette and layout mismatch raise JAX's AssertionErrors."""
    p = MCMCParams(n_colors=medium_er.max_degree)
    a = stepped(medium_er, p)
    ck = str(tmp_path / "ck.npz")
    a.save_checkpoint(a.init_state(seed=2), ck)
    with pytest.raises(AssertionError, match="graph mismatch"):
        stepped(small_er, MCMCParams(n_colors=medium_er.max_degree)).load_checkpoint(ck)
    with pytest.raises(AssertionError, match="palette mismatch"):
        stepped(medium_er, MCMCParams(n_colors=medium_er.max_degree - 1)).load_checkpoint(ck)
    with pytest.raises(AssertionError, match="layout mismatch"):
        stepped(medium_er, p, layout="bucketed").load_checkpoint(ck)


def test_jax_checkpoint_refused(medium_er, tmp_path):
    jp = JParams(n_colors=medium_er.max_degree)
    ja = JStepped(medium_er, jp)
    ck = str(tmp_path / "jax.npz")
    ja.save_checkpoint(ja.init_state(seed=2), ck)
    with pytest.raises(ValueError, match="JAX package"):
        stepped(medium_er, port_params(jp)).load_checkpoint(ck)


def test_stepped_matches_while_loop_statistically(small_er):
    p = MCMCParams(n_colors=small_er.max_degree, proposal=ProposalKind.STANDARD)
    g = interop.graph_from_jax(small_er)
    r1 = stepped(small_er, p).run(seed=6)
    r2 = tm.MCMCColorer(g, p, device="cpu").run(seed=6)
    assert r1.extra["final_conflicts"] == 0 == r2.extra["final_conflicts"]


def test_stepped_backends(small_er):
    with pytest.raises(ValueError, match="stepped chain"):
        stepped(small_er, MCMCParams(n_colors=small_er.max_degree), backend="matmul")
    api = stepped(small_er, MCMCParams(n_colors=small_er.max_degree), backend="auto")
    assert api.backend == "pallas"  # K2 on the card, its plain version here
