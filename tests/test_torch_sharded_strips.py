"""The sharded colorer's adjacency strips (``parallel/sharded.py``,
backend ``matmul`` over a host graph and ``resident_spec`` hash strips)
against the JAX package's ``ShardedMCMCColorer``, on the CPU.

- The strips equal JAX's bit for bit (uint32 words as int32): a host
  graph's strips (``_build_packed_strips``) stacked over the shards equal
  JAX's strips and JAX's ``build_packed_adjacency``; each shard's hash
  strip (``ops/hashgen.er_packed_strips_on_device``) equals JAX's shard;
  ``er_degrees_on_device`` equals JAX's.
- ``_strip_nc`` (K1's plain version here, on a strip with fewer rows
  than columns) equals JAX's ``_strip_nc`` (XLA
  ``_packed_neighbor_color_counts`` on the CPU), and the own-colour counts
  equal JAX's ``_nc_own_count``: exact.
- Whole runs on a 1x1 mesh, every chain fed JAX's own draws
  (``test_torch_sharded.JaxChainSource``; the strip tailcut's coins
  ``JaxStripTailcutSource``): the ``matmul`` run equals JAX's ``matmul``
  run and the port's ``xla`` run on the same draws, and the resident run
  equals JAX's resident run and the port's ``matmul`` run on the host
  rendition of the hash graph (tailcut off there: the two tailcuts
  differ by design): colours, iterations, traces, summaries and JAX's
  ``extra``, exactly, for full sweeps, Hastings, annealing and the
  frontier.
- One strip tailcut round equals JAX's ``_tailcut_strips_round`` on its
  coins (colours, conflicts and exit NC exact), also with the entry NC
  carried; a tight-palette resident run ends at 0 conflicts, valid
  against ``host_graph()``, equal to JAX's.
- JAX's refusals (``graph`` with ``resident_spec``, a backend other than
  ``matmul``, a strip over the card's budget "GB per shard" before any
  device work, a multigraph), and a checkpoint of a strip-backed run
  resumed equal to the uninterrupted run.

Exact equality everywhere: on these sizes the float32 proposal sums of
torch and XLA on the CPU pick the same colours (the CDF-boundary rule of
``tests/test_torch_sweep.py`` is not needed).  Multi-rank meshes are
``tests/test_torch_sharded_ranks.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.config import MCMCParams as JParams
from mcmc_colorer_tpu.config import ProposalKind as JKind
from mcmc_colorer_tpu.ops import dense_adj as jd
from mcmc_colorer_tpu.ops import hashgen as jh
from mcmc_colorer_tpu.parallel import sharded as js
from mcmc_colorer_tpu.parallel.mesh import make_mesh as j_make_mesh
from mcmc_colorer_tpu.parallel.sharded import AnnealConfig as JAnneal
from mcmc_colorer_tpu.parallel.sharded import ShardedMCMCColorer as JSharded
from mcmc_colorer_tpu.utils import rng as rngu

from mcmc_colorer_tpu_torch import interop
from mcmc_colorer_tpu_torch.config import MCMCParams
from mcmc_colorer_tpu_torch.graph.container import Graph
from mcmc_colorer_tpu_torch.models.base import check_coloring
from mcmc_colorer_tpu_torch.models.mcmc import _at_color
from mcmc_colorer_tpu_torch.ops import hashgen as th
from mcmc_colorer_tpu_torch.parallel import sharded as ts
from mcmc_colorer_tpu_torch.parallel.mesh import Mesh, make_mesh
from mcmc_colorer_tpu_torch.parallel.sharded import AnnealConfig, ShardedMCMCColorer

from test_torch_mcmc import port_params
from test_torch_sharded import JaxChainSource, JaxTailcutSource, assert_same_run

torch.set_num_threads(2)

CPU = torch.device("cpu")
# the hash graph of JAX's tests/test_resident.py:191-217 (1x1 here)
SPEC = (900, 0.04, 5)


def j_mesh(shards):
    return j_make_mesh(1, shards, devices=jax.devices()[:shards])


def rank_mesh(shards, s):
    """Shard s's view of a (1, shards) mesh, in this one process: no
    process group, so only code without collectives may run on it."""
    return Mesh(1, shards, 0, s, CPU)


class JaxStripTailcutSource:
    """The strip tailcut's coins as JAX draws them
    (``for_iteration(root, 999_999)``, ``k, kr = split(k)`` a round, shard
    s's ``uniform(fold_in(kr, s), (n_loc,))``), every shard's concatenated:
    one ``next(n_pad)`` a round."""

    def __init__(self, seed, shards, n_loc):
        root = rngu.for_repetition(rngu.root_key(seed), 0)
        self.key = rngu.for_iteration(root, 999_999)
        self.shards, self.n_loc = shards, n_loc

    def next(self, m):
        assert m == self.shards * self.n_loc
        self.key, kr = jax.random.split(self.key)
        return torch.from_numpy(np.concatenate([
            np.array(jax.random.uniform(jax.random.fold_in(kr, s), (self.n_loc,),
                                        dtype=jnp.float32))
            for s in range(self.shards)]))


def replay(seed, n_chains, shards, c, n, n_colors, strips_tailcut=False):
    """(chain sources, tailcut source) replaying JAX's draws for colorer ``c``."""
    srcs = [JaxChainSource(seed, k, shards, c.n_loc, n, n_colors, c.active_cap)
            for k in range(n_chains)]
    tsrc = (JaxStripTailcutSource(seed, shards, c.n_loc) if strips_tailcut
            else JaxTailcutSource(seed, shards, c.n_loc, n, n_colors))
    return srcs, tsrc


# ---- the strips ------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_host_graph_strips_match_jax(medium_er, shards):
    """Each shard's strip of the host graph (built from its own ELL rows,
    padding id n_pad) stacked over the shards equals JAX's sharded strips
    and JAX's ``build_packed_adjacency``, bit for bit; the strip has fewer
    rows than columns past one shard."""
    p = MCMCParams(n_colors=20)
    jc = JSharded(medium_er, JParams(n_colors=20), j_mesh(shards), backend="matmul")
    want = np.asarray(jc._adj_strip)
    assert np.array_equal(want, np.asarray(jd.build_packed_adjacency(medium_er, jc._n_pad)))
    g = interop.graph_from_jax(medium_er)
    parts = []
    for s in range(shards):
        c = ShardedMCMCColorer(g, p, rank_mesh(shards, s), backend="packed")
        assert c.backend == "matmul" and c.n_pad == jc._n_pad
        assert c.strip.shape == (c.n_loc, want.shape[1])
        parts.append(interop.adjacency_to_jax(c.strip))
    assert np.array_equal(np.concatenate(parts), want)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_hash_strips_and_degrees_match_jax(shards):
    """Shard s's hash strip equals rows [s·n_loc, (s+1)·n_loc) of JAX's
    sharded strips, bit for bit, and the degrees built with it are its
    rows' of JAX's; the banded degree pass equals JAX's, on one device and
    (its rows) shard by shard."""
    n, prob, seed = SPEC
    n_pad = 1024 * shards if shards > 1 else 1024
    want = np.asarray(jh.er_packed_strips_on_device(n, prob, seed, n_pad, j_mesh(shards)))
    n_loc = n_pad // shards
    deg_j = np.asarray(jh.er_degrees_on_device(n, prob, seed, row_chunk=128, mesh=j_mesh(shards)))
    deg_pad = np.zeros(n_pad, np.int32)
    deg_pad[:n] = deg_j
    for s in range(shards):
        got, got_deg = th.er_packed_strips_on_device(n, prob, seed, n_pad, rank_mesh(shards, s),
                                                     row_chunk=200)  # ragged last band
        assert np.array_equal(interop.adjacency_to_jax(got), want[s * n_loc:(s + 1) * n_loc])
        assert np.array_equal(got_deg.numpy(), deg_pad[s * n_loc:(s + 1) * n_loc])
    assert np.array_equal(deg_j, np.asarray(jh.er_degrees_on_device(n, prob, seed)))
    assert np.array_equal(th.er_degrees_on_device(n, prob, seed, row_chunk=96,
                                                  device="cpu").numpy(), deg_j)
    # on a mesh a rank computes its rows (the all-gather over its shard
    # group, an identity without a process group, is tests/test_torch_sharded_ranks.py's)
    rows = -(-n // (shards * 128)) * 128
    padded = np.zeros(shards * rows, np.int32)
    padded[:n] = deg_j
    for s in range(shards):
        got = th.er_degrees_on_device(n, prob, seed, row_chunk=128, mesh=rank_mesh(shards, s))
        assert got.shape == (min(rows, n),)
        assert np.array_equal(got.numpy(), padded[s * rows:s * rows + got.shape[0]])


@pytest.mark.parametrize("n_colors,chains", [(20, 1), (40, 3), (150, 2)])
def test_strip_nc_matches_jax(n_colors, chains):
    """``_strip_nc`` on shard 1 of a (1, 4) layout (a [256, 128]-word strip:
    256 rows, 4096 columns) for whole colour vectors with phantoms,
    against JAX's ``_strip_nc`` chain by chain, and the own-colour counts
    against JAX's ``_nc_own_count``: exact."""
    n, prob, seed = SPEC
    n_pad, shards, s = 1024, 4, 1
    n_loc = n_pad // shards
    strip, _ = th.er_packed_strips_on_device(n, prob, seed, n_pad, rank_mesh(shards, s))
    strip_j = jnp.asarray(interop.adjacency_to_jax(strip))
    rng = np.random.default_rng(n_colors)
    colors = rng.integers(0, n_colors, (chains, n_pad)).astype(np.int32)
    colors[:, n:] = n_colors
    full_real = torch.arange(n_pad) < n
    got = ts._strip_nc(strip, torch.from_numpy(colors), full_real, n_colors)
    assert got.shape == (chains, n_loc, (n_colors + 127) // 128 * 128)
    own = torch.from_numpy(colors[:, s * n_loc:(s + 1) * n_loc])
    cnt = _at_color(got, own)
    for k in range(chains):
        want = js._strip_nc(strip_j, jnp.asarray(colors[k]), jnp.asarray(full_real.numpy()),
                            n_colors)
        assert np.array_equal(got[k].numpy(), np.asarray(want))
        assert np.array_equal(cnt[k].numpy(), np.asarray(js._nc_own_count(want, own[k].numpy())))
    one = ts._strip_nc(strip, torch.from_numpy(colors[0]), full_real, n_colors)
    assert torch.equal(one, got[0])


# ---- whole runs on JAX's draws -------------------------------------------

# name -> (JAX params, palette divisor of the max degree, colorer kwargs)
RUNS = {
    "full": (dict(max_iterations=40), 2, {}),
    "tailcut": (dict(max_iterations=10, tailcut=True), 3, {}),
    "hastings": (dict(hastings=True, lambda_=25.0, max_iterations=30), 2, {}),
    "anneal": (dict(max_iterations=30), 4, dict(anneal=True)),
    "frontier": (dict(max_iterations=60, taboo_iterations=2), 3, dict(active_cap=128)),
    "anneal_frontier": (dict(max_iterations=30, tailcut=True), 3,
                        dict(anneal=True, active_cap=128)),
}


def run_setup(max_degree, case):
    """(JAX params, port params, JAX kwargs, port kwargs) of ``RUNS[case]``."""
    jkw, div, kw = RUNS[case]
    jp = JParams(n_colors=max(4, max_degree // div), **jkw)
    kw = dict(kw)
    anneal = kw.pop("anneal", False)
    return (jp, port_params(jp), {**kw, "anneal": JAnneal(enabled=anneal, window=3)},
            {**kw, "anneal": AnnealConfig(enabled=anneal, window=3)})


def exercised(case, best, summaries):
    x = best.extra
    if "frontier" in case:
        assert x["frontier_sweeps"] > 0
    if case == "hastings":
        assert any(s["accepted_sweeps"] < s["attempted_sweeps"] for s in summaries)
    if case == "anneal":
        assert x["final_eps_scale"] > 1.0
    if case == "tailcut":
        assert x["tailcut_rounds"] > 0


@pytest.mark.parametrize("case", list(RUNS))
def test_matmul_run_matches_jax_and_xla(medium_er, case):
    """The ``matmul`` strip run on JAX's draws equals JAX's ``matmul``
    run, and the port's ``xla`` run on the same draws (its tailcut is the
    rank-space one, K3's plain version, as JAX's)."""
    jp, p, jkw, kw = run_setup(medium_er.max_degree, case)
    seed, n_chains = 21, 3
    want = JSharded(medium_er, jp, j_mesh(1), n_chains=n_chains, backend="matmul",
                    **jkw).run(seed=seed)
    g = interop.graph_from_jax(medium_er)
    got = {}
    for backend in ("matmul", "xla"):
        c = ShardedMCMCColorer(g, p, make_mesh(1, 1, device="cpu"), n_chains=n_chains,
                               backend=backend, **kw)
        srcs, tsrc = replay(seed, n_chains, 1, c, g.n, p.n_colors)
        got[backend] = c.run(seed=seed, sources=srcs, tailcut_source=tsrc)
        assert_same_run(got[backend], want)
    exercised(case, *got["matmul"])


@pytest.mark.parametrize("case", ["full", "hastings", "anneal", "frontier"])
def test_resident_run_matches_jax_and_classic(case):
    """The resident strip run on JAX's draws equals JAX's resident run;
    with the tailcut off (the strip and rank-space tailcuts differ by
    design) it equals the port's ``matmul`` run on the host rendition of
    the same hash graph, chain by chain (JAX tests/test_resident.py:195-217
    and tests/test_resident_active.py:105-135)."""
    n, prob, seed_g = SPEC
    g = th_host_graph()
    jp, p, jkw, kw = run_setup(g.max_degree, case)
    seed, n_chains = 7, 2
    want = JSharded(None, jp, j_mesh(1), n_chains=n_chains, resident_spec=SPEC,
                    **jkw).run(seed=seed)
    c = ShardedMCMCColorer(None, p, make_mesh(1, 1, device="cpu"), n_chains=n_chains,
                           resident_spec=SPEC, **kw)
    assert c.graph.n == n and c.graph.max_degree == g.max_degree
    assert c.graph.n_edges == g.n_edges and c.neighbors is None
    srcs, tsrc = replay(seed, n_chains, 1, c, n, p.n_colors)
    got = c.run(seed=seed, sources=srcs, tailcut_source=tsrc)
    assert_same_run(got, want)
    exercised(case, *got)
    classic = ShardedMCMCColorer(g, p, make_mesh(1, 1, device="cpu"), n_chains=n_chains,
                                 backend="matmul", **kw)
    srcs, tsrc = replay(seed, n_chains, 1, classic, n, p.n_colors)
    cls = classic.run(seed=seed, sources=srcs, tailcut_source=tsrc)
    assert_same_run(cls, want)


def th_host_graph():
    """The host rendition of ``SPEC`` (the native C++ enumeration)."""
    from mcmc_colorer_tpu_torch.graph.native import generate_er_hash

    n, prob, seed = SPEC
    return generate_er_hash(n, th.er_threshold(prob), seed)


# ---- the strip tailcut ------------------------------------------------------


def test_tailcut_strips_round_matches_jax():
    """Two rounds of the strip tailcut on JAX's coins, from a greedy
    colouring of the hash graph with 8 vertices recoloured to a
    neighbour's colour (few heads, so that some have no head neighbour),
    the second round with the first's exit NC carried: colours, global
    conflicts and exit NC equal JAX's ``_tailcut_strips_round``, and
    conflicts fall."""
    g = th_host_graph()
    n, n_colors = g.n, g.max_degree + 1
    cols = np.full(1024, n_colors, np.int32)
    for v in range(n):  # first fit in id order
        used = set(cols[g.cols[g.row_ptr[v]:g.row_ptr[v + 1]]].tolist())
        cols[v] = min(set(range(n_colors)) - used)
    rng = np.random.default_rng(3)
    for v in rng.choice(n, 8, replace=False):
        cols[v] = cols[g.cols[g.row_ptr[v]]]
    p = MCMCParams(n_colors=n_colors, tailcut=True)
    jp = JParams(n_colors=n_colors, tailcut=True)
    c = ShardedMCMCColorer(None, p, make_mesh(1, 1, device="cpu"), resident_spec=SPEC)
    jc = JSharded(None, jp, j_mesh(1), resident_spec=SPEC)
    assert c.n_pad == jc._n_pad == cols.shape[0]
    src = JaxStripTailcutSource(11, 1, c.n_loc)
    key = src.key
    cols_t, cols_j = torch.from_numpy(cols), jnp.asarray(cols)
    nc_t = nc_j = None
    confs = []
    for r in range(2):
        key, kr = jax.random.split(key)
        kw = {} if nc_j is None else {"nc_prev": nc_j}
        cols_j, conf_j, nc_j = js._tailcut_strips_round(
            jc._adj_strip, cols_j, jax.random.key_data(kr), mesh=jc.mesh, params=jp,
            n_nodes=n, **kw)
        cols_t, conf_t, nc_t = c._tailcut_strips_round(cols_t, src.next(c.n_pad), nc_t)
        assert np.array_equal(cols_t.numpy(), np.asarray(cols_j)), r
        assert conf_t == int(conf_j)
        assert np.array_equal(nc_t.numpy(), np.asarray(nc_j))
        confs.append(conf_t)
    entry = int(_at_color(ts._strip_nc(c.strip, torch.from_numpy(cols), c._full_real, n_colors),
                          torch.from_numpy(cols)).sum()) // 2
    assert entry >= confs[0] >= confs[1] and entry > confs[1]


def strip_finish(mesh):
    """The strip tailcut of ``SPEC`` at nCol = max degree on ``mesh``, from
    ``test_torch_resident.planted_conflict``'s one conflict with coins
    that keep both ends alike (``InStep``), so its rounds reach their cap.
    Returns (colours [n_pad], conflicts, rounds, the colours the serial
    first-free pass must give)."""
    from test_torch_resident import InStep, planted_conflict

    c = ShardedMCMCColorer(None, MCMCParams(n_colors=0, tailcut=True), mesh, resident_spec=SPEC)
    _, n_colors, planted, _, want = planted_conflict(*SPEC, c.n_pad)
    assert c.params.n_colors == n_colors
    cols, conf, rounds = c._tailcut_strips(torch.from_numpy(planted), 1, InStep())
    return cols.numpy(), conf, rounds, want


def test_strip_tailcut_cap_ends_with_the_first_free_pass():
    """The strip tailcut ends where its rounds' cap leaves a conflict as
    the single-card tailcut does: the serial first-free pass gives the
    colours it must (the lower end on its smallest free colour, the other
    kept), 0 conflicts, a proper colouring, after 16 + 2 rounds; equal to
    ``mcmc_resident._finish_first_free`` over the whole A."""
    from mcmc_colorer_tpu_torch.models import mcmc_resident as mr
    from test_torch_resident import planted_conflict

    cols, conf, rounds, want = strip_finish(make_mesh(1, 1, device="cpu"))
    assert (conf, rounds) == (0, 18) and np.array_equal(cols, want)
    assert check_coloring(th_host_graph(), cols[:SPEC[0]])
    n, n_pad = SPEC[0], cols.shape[0]
    adj = th.er_packed_on_device(*SPEC, n_pad, row_chunk=n_pad, device="cpu")
    _, n_colors, planted, _, _ = planted_conflict(*SPEC, n_pad)
    out, conf1 = mr._finish_first_free(adj, torch.from_numpy(planted)[None], np.array([1]),
                                       torch.arange(n_pad) < n, n_colors=n_colors)
    assert np.array_equal(out[0].numpy(), cols) and conf1.tolist() == [0]


def test_tight_palette_resident_run_is_valid_and_matches_jax():
    """A palette of half the max degree leaves conflicts to the strip
    tailcut, which ends at 0 conflicts, valid against the host graph and
    equal to JAX's run on its draws (JAX tests/test_resident.py:219-245)."""
    spec = (1200, 0.04, 21)
    c0 = ShardedMCMCColorer(None, MCMCParams(n_colors=0, tailcut=True),
                            make_mesh(1, 1, device="cpu"), n_chains=2, resident_spec=spec)
    maxdeg = c0.graph.max_degree
    assert c0.params.n_colors == maxdeg
    jp = JParams(n_colors=max(4, maxdeg // 2), proposal=JKind.BALANCE_DYNAMIC, tailcut=True,
                 max_iterations=40)
    want = JSharded(None, jp, j_mesh(1), n_chains=2, resident_spec=spec).run(seed=4)
    p = port_params(jp)
    c = ShardedMCMCColorer(None, p, make_mesh(1, 1, device="cpu"), n_chains=2,
                           resident_spec=spec)
    srcs, tsrc = replay(4, 2, 1, c, spec[0], p.n_colors, strips_tailcut=True)
    got = c.run(seed=4, sources=srcs, tailcut_source=tsrc)
    assert_same_run(got, want)
    best = got[0]
    assert best.extra["tailcut_rounds"] > 0 and best.extra["final_conflicts"] == 0
    assert check_coloring(c.host_graph(), best.colors)
    # and on the port's own draws
    own = c.run(seed=4)[0]
    assert own.extra["final_conflicts"] == 0 and check_coloring(c.host_graph(), own.colors)


# ---- refusals, checkpoints ------------------------------------------------


def test_refusals_match_jax(medium_er, monkeypatch):
    """JAX's refusals: a graph with ``resident_spec``, a backend other
    than ``matmul`` with it, a strip over the card's budget ("GB per
    shard", before any device work, also where the palette is still to be
    resolved), a multigraph on the strip backend."""
    mesh, jm = make_mesh(1, 1, device="cpu"), j_mesh(1)
    g = interop.graph_from_jax(medium_er)
    for kw, err in ((dict(graph=g), "graph=None"), (dict(backend="xla"), "matmul")):
        with pytest.raises(ValueError, match=err):
            ShardedMCMCColorer(kw.get("graph"), MCMCParams(n_colors=8), mesh,
                               resident_spec=(300, 0.05, 1), backend=kw.get("backend", "auto"))
        with pytest.raises(ValueError, match=err):
            JSharded(medium_er if "graph" in kw else None, JParams(n_colors=8), jm,
                     resident_spec=(300, 0.05, 1), backend=kw.get("backend", "auto"))

    def no_device_work(*a, **k):
        raise AssertionError("device work before the strip precheck")

    monkeypatch.setattr(ts, "er_degrees_on_device", no_device_work)
    monkeypatch.setattr(ts, "er_packed_strips_on_device", no_device_work)
    for n_colors in (0, 1000):
        with pytest.raises(ValueError, match="GB per shard"):
            ShardedMCMCColorer(None, MCMCParams(n_colors=n_colors), mesh,
                               resident_spec=(4_000_000, 1e-4, 0))
        with pytest.raises(ValueError, match="GB per shard"):
            JSharded(None, JParams(n_colors=n_colors), jm, resident_spec=(4_000_000, 1e-4, 0))
    # a duplicate edge collapses to one bit of the strip
    rp, cols = g.row_ptr.copy(), g.cols.copy()
    dup = Graph(n=g.n, row_ptr=np.concatenate([[0], rp[1:] + 1]),
                cols=np.concatenate([cols[:1], cols]).astype(np.int32))
    with pytest.raises(ValueError, match="duplicate edges"):
        ShardedMCMCColorer(dup, MCMCParams(n_colors=8), mesh, backend="matmul")


@pytest.mark.parametrize("resident", [False, True], ids=["matmul", "resident"])
def test_strip_checkpoint_resumed_equal(medium_er, tmp_path, resident):
    """On the port's own draws: segments of 3 sweeps with a checkpoint each,
    and a fresh colorer resumed from a checkpoint written after 2 sweeps,
    both equal the uninterrupted run (the frontier on, so the carried cnt
    is used)."""
    g = interop.graph_from_jax(medium_er)
    maxdeg = th_host_graph().max_degree if resident else g.max_degree
    p = MCMCParams(n_colors=max(4, maxdeg // 3), max_iterations=30, taboo_iterations=2,
                   tailcut=True)
    mesh = make_mesh(1, 1, device="cpu")
    make = ((lambda: ShardedMCMCColorer(None, p, mesh, n_chains=2, resident_spec=SPEC,
                                        active_cap=128)) if resident  # noqa: E731
            else (lambda: ShardedMCMCColorer(g, p, mesh, n_chains=2, backend="matmul",
                                             active_cap=128)))
    ref = make().run(seed=9)
    ck = str(tmp_path / "strips.npz")
    assert_same_run(make().run(seed=9, segment=3, checkpoint_path=ck), ref)
    c1 = make()
    c1.save_checkpoint(c1._run_sharded_segment(c1.init_state(seed=9), 2), ck)
    assert int(np.load(ck)["rip"]) == 2
    assert_same_run(make().run(seed=9, resume_from=ck), ref)
