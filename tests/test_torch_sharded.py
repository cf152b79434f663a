"""The port's sharded ensemble (``parallel/sharded.py``) against the JAX
package's ``ShardedMCMCColorer`` on a 1x1 mesh, on the CPU.

- Every chain is fed JAX's own draws for that chain, replayed through
  the port's source protocol (``JaxChainSource``: the initial colouring,
  each full sweep's ``fold_in(k_u, shard)`` uniforms, Hastings' ``k_acc``,
  each frontier sweep's five-way split; ``JaxTailcutSource``: each
  tailcut round's ``randint``).  Colours, iterations, conflict traces,
  per-chain summaries and JAX's ``extra`` must be equal (exact) for the
  ``xla`` and ``pallas`` backends (JAX's Pallas sweep in interpret mode,
  the port's K2 plain version), full and frontier sweeps, Hastings,
  annealing and the tailcut.
- A JAX checkpoint resumed by the port through
  ``interop.sharded_state_from_numpy`` ends where JAX's uninterrupted run
  ends (exact).
- The port's own resume: a segmented run equals the single-shot run, and
  a checkpoint written mid-run and resumed by a fresh colorer equals the
  uninterrupted run (exact).
- K2 and K3 at the sharded call sites: their plain versions on shard 1's
  rows of a (1, 2) layout (own ids from ``row0``, the whole colour
  vector) against JAX's Pallas kernels (interpret mode) on the same rows:
  K3 exact, K2's conflicts exact and its samples under the CDF-boundary
  rule of ``tests/test_torch_sweep.py``.
- The refusals (Hastings with a frontier, JAX's refusals of the strip
  paths) and the card as default device.

Multi-rank meshes are ``tests/test_torch_sharded_ranks.py``; the strip
backend and the resident hash strips ``tests/test_torch_sharded_strips.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.config import MCMCParams as JParams
from mcmc_colorer_tpu.parallel.mesh import make_mesh as j_make_mesh
from mcmc_colorer_tpu.parallel.sharded import AnnealConfig as JAnneal
from mcmc_colorer_tpu.parallel.sharded import ShardedMCMCColorer as JSharded
from mcmc_colorer_tpu.utils import rng as rngu

from mcmc_colorer_tpu_torch import interop
from mcmc_colorer_tpu_torch.config import MCMCParams
from mcmc_colorer_tpu_torch.models.base import check_coloring
from mcmc_colorer_tpu_torch.parallel.mesh import make_mesh
from mcmc_colorer_tpu_torch.parallel.sharded import AnnealConfig, ShardedMCMCColorer

from test_torch_mcmc import port_params

torch.set_num_threads(2)


class JaxChainSource:
    """Chain ``chain``'s JAX key, split as JAX's ``ShardedMCMCColorer``
    splits it, answering the port's draws in the order the port takes
    them; a sweep's draw is every shard's, concatenated in shard order
    (rank s keeps its part).  ``key`` (raw key data) starts from a
    checkpoint's loop key instead of the chain's initial key."""

    def __init__(self, seed, chain, shards, n_loc, n, n_colors, cap=None, key=None):
        self.init = key is None
        if key is None:
            root = rngu.for_repetition(rngu.root_key(seed), 0)
            key = rngu.for_chain(root, jnp.uint32(chain))
        else:
            key = jax.random.wrap_key_data(jnp.asarray(key))
        self.key, self.shards, self.n_loc, self.n = key, shards, n_loc, n
        self.n_colors, self.cap = n_colors, cap
        self.pending, self.after_full = [], False

    def _per_shard(self, k, size):
        return np.concatenate([
            np.array(jax.random.uniform(jax.random.fold_in(k, s), (size,), dtype=jnp.float32))
            for s in range(self.shards)])

    def next(self, m):
        if self.pending:  # the ε-flip's uniform
            u = self.pending.pop(0)
            assert u.dtype == np.float32 and u.shape == (m,), (u.shape, m)
            return torch.from_numpy(u)
        if self.init:  # _sharded_init: k_init, k_loop = split(key)
            self.init = False
            k_init, self.key = jax.random.split(self.key)
            assert m == self.n
            u = np.array(jax.random.uniform(k_init, (self.shards * self.n_loc,),
                                            dtype=jnp.float32))
            return torch.from_numpy(u[:m].copy())
        if m == 1 and self.after_full:  # Hastings: key, k_acc = split(key)
            self.after_full = False
            self.key, k_acc = jax.random.split(self.key)
            return torch.from_numpy(
                np.array(jax.random.uniform(k_acc, (), dtype=jnp.float32)).reshape(1))
        if m == self.n:  # chain_sweep: key, k_u = split(key)
            self.key, ku = jax.random.split(self.key)
            self.after_full = True
            return torch.from_numpy(self._per_shard(ku, self.n_loc)[:m].copy())
        # active_branch: key, k_u, k_f1, k_f2, k_f3 = split(key, 5)
        assert self.cap is not None and m == self.shards * self.cap, (m, self.cap)
        self.after_full = False
        self.key, ku, kf1, kf2, kf3 = jax.random.split(self.key, 5)
        self.pending = [
            np.array(jax.random.uniform(kf1, (), dtype=jnp.float32)).reshape(1),
            np.array(jax.random.randint(kf2, (), 0, self.n, dtype=jnp.int32)).reshape(1),
            np.array(jax.random.randint(kf3, (), 1, max(self.n_colors, 2),
                                        dtype=jnp.int32)).reshape(1),
        ]
        return torch.from_numpy(self._per_shard(ku, self.cap))

    def randint(self, m, high, low=0):
        r = self.pending.pop(0)
        assert r.dtype == np.int32 and r.shape == (m,), (r.shape, m)
        assert low <= r.min() and r.max() < high
        return torch.from_numpy(r)


class JaxTailcutSource:
    """The tailcut's key (``for_iteration(root, 999_999)``): round r draws
    every shard's ``randint(fold_in(fold_in(key, r), shard))``,
    concatenated."""

    def __init__(self, seed, shards, n_loc, n, n_colors):
        root = rngu.for_repetition(rngu.root_key(seed), 0)
        self.key = rngu.for_iteration(root, 999_999)
        self.shards, self.n_loc, self.n, self.n_colors = shards, n_loc, n, n_colors
        self.round = 0

    def randint(self, m, high, low=0):
        assert (m, high, low) == (self.n, self.n_colors, 0)
        k = jax.random.fold_in(self.key, self.round)
        self.round += 1
        r = np.concatenate([
            np.array(jax.random.randint(jax.random.fold_in(k, s), (self.n_loc,), 0, high,
                                        dtype=jnp.int32))
            for s in range(self.shards)])
        return torch.from_numpy(r[:m].copy())


def jax_sources(seed, n_chains, shards, n_loc, n, n_colors, cap):
    return ([JaxChainSource(seed, c, shards, n_loc, n, n_colors, cap) for c in range(n_chains)],
            JaxTailcutSource(seed, shards, n_loc, n, n_colors))


# name -> (JAX params, palette divisor of the max degree, colorer kwargs):
# full sweeps on both backends (with enough conflicts left for the
# tailcut), frontier sweeps on both, Hastings on both, annealing with
# boosts, and annealing with a frontier
CASES = {
    "xla": (dict(max_iterations=40), 2, dict(backend="xla")),
    "pallas_tailcut": (dict(max_iterations=10, tailcut=True), 3, dict(backend="pallas")),
    "frontier_xla": (dict(max_iterations=60), 2, dict(backend="xla", active_cap=128)),
    "frontier_pallas": (dict(max_iterations=60, taboo_iterations=2), 3,
                        dict(backend="pallas", active_cap=128)),
    "hastings_xla": (dict(hastings=True, lambda_=25.0, max_iterations=30), 2,
                     dict(backend="xla")),
    "hastings_pallas": (dict(hastings=True, lambda_=25.0, max_iterations=30), 2,
                        dict(backend="pallas")),
    "anneal": (dict(max_iterations=30), 4, dict(backend="xla", anneal=True)),
    "anneal_frontier": (dict(max_iterations=30, tailcut=True), 3,
                        dict(backend="pallas", anneal=True, active_cap=128)),
}


def case_setup(jg, case):
    """(JAX params, port params, JAX kwargs, port kwargs) of ``CASES[case]``."""
    jkw, div, kw = CASES[case]
    jp = JParams(n_colors=max(4, jg.max_degree // div), **jkw)
    kw = dict(kw)
    anneal = kw.pop("anneal", False)
    return (jp, port_params(jp), {**kw, "anneal": JAnneal(enabled=anneal, window=3)},
            {**kw, "anneal": AnnealConfig(enabled=anneal, window=3)})


TIMES = ("chain_seconds", "tailcut_seconds", "setup_seconds")


def assert_same_run(got, want):
    """Equal best colouring, iterations, trace, summaries and ``want``'s
    extra but its times."""
    (gb, gs), (wb, ws) = got, want
    assert gs == ws
    assert np.array_equal(gb.colors, np.asarray(wb.colors))
    assert gb.iterations == wb.iterations
    assert np.array_equal(gb.conflict_trace, np.asarray(wb.conflict_trace))
    keys = [k for k in wb.extra if k not in TIMES]
    assert {k: gb.extra[k] for k in keys} == {k: wb.extra[k] for k in keys}
    assert gb.converged == wb.converged


def exercised(case, x, summaries):
    """The case ran the path it names (``x``: the best run's extra)."""
    if case.startswith("frontier") or case == "anneal_frontier":
        assert x["frontier_sweeps"] > 0
    if case.startswith("hastings"):
        assert any(s["accepted_sweeps"] < s["attempted_sweeps"] for s in summaries)
    if case == "anneal":
        assert x["final_eps_scale"] > 1.0
    if case == "pallas_tailcut":
        assert x["tailcut_rounds"] > 0


@pytest.mark.parametrize("case", list(CASES))
def test_one_by_one_matches_jax_on_its_draws(medium_er, case):
    jp, p, jkw, kw = case_setup(medium_er, case)
    seed, n_chains = 21, 3
    ja = JSharded(medium_er, jp, j_make_mesh(1, 1, devices=jax.devices()[:1]),
                  n_chains=n_chains, **jkw)
    want = ja.run(seed=seed)
    c = ShardedMCMCColorer(interop.graph_from_jax(medium_er), p, make_mesh(1, 1, device="cpu"),
                           n_chains=n_chains, **kw)
    assert c.n_pad == ja._n_pad and c.active_cap == ja.active_cap
    srcs, tsrc = jax_sources(seed, n_chains, 1, c.n_loc, medium_er.n, p.n_colors, c.active_cap)
    got = c.run(seed=seed, sources=srcs, tailcut_source=tsrc)
    assert_same_run(got, want)
    exercised(case, got[0].extra, got[1])


def test_jax_checkpoint_resumed_by_the_port(medium_er, tmp_path):
    """JAX runs 3 sweeps and writes its checkpoint; the port takes the 11
    fields (``interop.sharded_state_from_numpy``), continues each chain
    from its checkpointed key, and ends where JAX's uninterrupted run
    ends; the frontier path, so the carried cnt is used as it stands."""
    jp, p, jkw, kw = case_setup(medium_er, "frontier_pallas")
    seed, n_chains = 21, 2
    # one JAX colorer for both runs: its segment program compiles once
    j1 = JSharded(medium_er, jp, j_make_mesh(1, 1, devices=jax.devices()[:1]),
                  n_chains=n_chains, **jkw)
    want = j1.run(seed=seed)
    state = j1.init_state(seed)
    state = j1._jit_segment(j1._sharded_neighbors(), j1._adj_strip, state, jnp.int32(3))
    ck = str(tmp_path / "jax.npz")
    j1.save_checkpoint(state, ck)
    d = np.load(ck)
    assert int(d["rip"]) == 3
    c = ShardedMCMCColorer(interop.graph_from_jax(medium_er), p, make_mesh(1, 1, device="cpu"),
                           n_chains=n_chains, **kw)
    srcs = [JaxChainSource(seed, k, 1, c.n_loc, medium_er.n, p.n_colors, c.active_cap,
                           key=d["keydata"][k]) for k in range(n_chains)]
    st = interop.sharded_state_from_numpy(c, {k: d[k] for k in d.files}, srcs)
    assert st.rip == 3 and np.array_equal(st.trace, d["trace"])
    tsrc = JaxTailcutSource(seed, 1, c.n_loc, medium_er.n, p.n_colors)
    got = c.run(seed=seed, tailcut_source=tsrc, state=st)
    assert_same_run(got, want)
    assert got[0].extra["frontier_sweeps"] > 0


@pytest.mark.parametrize("case", ["frontier_pallas", "hastings_xla", "anneal"])
def test_resume_equals_uninterrupted(medium_er, tmp_path, case):
    """The port's own draws: segments of 3 sweeps (with a checkpoint each)
    equal the single-shot run, and so does a fresh colorer resumed from
    a checkpoint written after 2 sweeps (its generator states carried)."""
    _, p, _, kw = case_setup(medium_er, case)
    g = interop.graph_from_jax(medium_er)
    mesh = make_mesh(1, 1, device="cpu")
    make = lambda: ShardedMCMCColorer(g, p, mesh, n_chains=3, **kw)  # noqa: E731
    ref = make().run(seed=9)
    ck = str(tmp_path / "ens.npz")
    seg = make().run(seed=9, segment=3, checkpoint_path=ck)
    assert_same_run(seg, ref)
    c1 = make()
    st = c1._run_sharded_segment(c1.init_state(seed=9), 2)
    c1.save_checkpoint(st, ck)
    d = np.load(ck)
    assert int(d["rip"]) == 2 and d["colors"].shape == (3, c1.n_pad) and d["rng"].shape[0] == 3
    res = make().run(seed=9, resume_from=ck)
    assert_same_run(res, ref)
    assert check_coloring(g, res[0].colors) or res[0].extra["final_conflicts"] > 0


def test_sharded_call_sites_of_k2_and_k3(medium_er):
    """K2 and K3's plain versions over shard 1's real rows of a (1, 2)
    layout (own ids ``row0 = n_loc``, colours the whole vector, the
    rank's neighbour rows), as ``_full_branch`` and ``_tailcut_round``
    call them, against JAX's Pallas kernels in interpret mode on the same
    rows with ``self_ids``: K3 exact; K2's conflicts exact, its samples
    under the CDF-boundary rule (``tests/test_torch_resample.py``), taboo
    equal and qstar within 1e-5 relative where the samples agree."""
    from mcmc_colorer_tpu.models import mcmc as jm
    from mcmc_colorer_tpu.ops.neighbor import occupancy_matrix as j_occ
    from mcmc_colorer_tpu.ops.pallas_firstfit import pallas_first_fit
    from mcmc_colorer_tpu.ops.pallas_resample import pallas_sweep

    from mcmc_colorer_tpu_torch.config import ProposalKind
    from mcmc_colorer_tpu_torch.ops import firstfit as k3
    from mcmc_colorer_tpu_torch.ops import resample as k2
    from test_torch_resample import assert_boundary_only

    from mcmc_colorer_tpu.config import ProposalKind as JKind

    kw = dict(n_colors=medium_er.max_degree // 2, taboo_iterations=2, epsilon=1e-3)
    p = MCMCParams(proposal=ProposalKind.STANDARD, **kw)
    jp = JParams(proposal=JKind.STANDARD, **kw)
    g = interop.graph_from_jax(medium_er)
    jc = JSharded(medium_er, jp, j_make_mesh(1, 2, devices=jax.devices()[:2]))
    n_pad, n_loc = jc._n_pad, jc._n_pad // 2
    assert n_loc < g.n  # shard 1 owns real rows
    rows = g.to_ell(pad_nodes_to=n_pad, device="cpu").neighbors[n_loc:g.n].contiguous()
    nr = rows.shape[0]
    rng = np.random.default_rng(4)
    colors = rng.integers(0, p.n_colors, n_pad).astype(np.int32)
    colors[g.n:] = p.n_colors
    cur = colors[n_loc:g.n].copy()
    taboo = rng.integers(0, 3, nr).astype(np.int32)
    unif = rng.random(nr, dtype=np.float32)
    tc = torch.from_numpy
    star, qstar, new_tb, conf = k2.resample_sweep(rows, tc(colors[:g.n].copy()), tc(cur),
                                                  tc(taboo), n_loc, tc(unif), None, 1e-3, p)
    nb = rows.numpy()
    nc = np.concatenate([colors, [-1]]).astype(np.int32)[np.minimum(nb, n_pad)]
    # JAX's kernels take whole 128-row blocks: padding rows (no
    # neighbours, colour nCol, taboo 0) are cut off after
    hp = -(-nr // 128) * 128

    def pad(x, fill):
        return jnp.asarray(np.concatenate([x, np.full((hp - nr, *x.shape[1:]), fill, x.dtype)]))

    gids = n_loc + np.arange(nr, dtype=np.int32)
    want = pallas_sweep(pad(nc, -1), pad(nb, n_pad), pad(cur, p.n_colors), pad(taboo, 0),
                        pad(unif, 0.5), jnp.zeros((p.n_colors,), jnp.float32),
                        jnp.float32(1e-3), params=jp, block=128, self_ids=pad(gids, n_pad))
    star_j, qstar_j, taboo_j, conf_j = (np.asarray(x)[:nr] if np.ndim(x) else np.asarray(x)
                                        for x in want)
    assert int(conf) == int(conf_j)
    q_j = jm._proposal_q(jnp.asarray(cur), j_occ(jnp.asarray(nc), p.n_colors), jp, None,
                         eps=jnp.float32(1e-3))
    mism = assert_boundary_only(star.numpy(), star_j, unif, np.asarray(jnp.cumsum(q_j, 1)), nr)
    keep = np.ones(nr, bool)
    keep[mism] = False
    assert np.array_equal(new_tb.numpy()[keep], taboo_j[keep])
    np.testing.assert_allclose(qstar.numpy()[keep], qstar_j[keep], rtol=1e-5)
    allow = np.ones(p.n_colors, np.int32)
    ff = k3.first_fit(rows, tc(colors), tc(allow), p.n_colors)
    jff = pallas_first_fit(pad(nc, -1), jnp.asarray(allow), n_colors=p.n_colors, block=128)
    assert np.array_equal(ff.numpy(), np.asarray(jff)[:nr])


def test_refusals_and_default_device(medium_er, monkeypatch):
    """Hastings with a frontier refuses, and so do JAX's refusals of the
    strip paths (a graph with ``resident_spec``, a backend other than
    ``matmul`` with it, an unknown backend), each as JAX's colorer does;
    without a card the default mesh device raises and names it; the mesh
    refuses a geometry larger than the world, naming torchrun."""
    g = interop.graph_from_jax(medium_er)
    mesh = make_mesh(1, 1, device="cpu")
    jmesh = j_make_mesh(1, 1, devices=jax.devices()[:1])
    with pytest.raises(NotImplementedError, match="full sweeps"):
        ShardedMCMCColorer(g, MCMCParams(n_colors=20, hastings=True), mesh, active_cap=128)
    for kw, err in ((dict(graph=True, resident_spec=(500, 0.05, 1)), "graph=None"),
                    (dict(backend="xla", resident_spec=(500, 0.05, 1)), "matmul"),
                    (dict(graph=True, backend="dense"), "unknown sharded backend")):
        kw = dict(kw)
        with_graph = kw.pop("graph", False)
        with pytest.raises(ValueError, match=err):
            ShardedMCMCColorer(g if with_graph else None, MCMCParams(n_colors=20), mesh, **kw)
        with pytest.raises(ValueError, match=err):
            JSharded(medium_er if with_graph else None, JParams(n_colors=20), jmesh, **kw)
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(1, 2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, 1)
