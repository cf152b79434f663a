"""The NC-native tailcut round of the port against the JAX package's.

A round is integer work once the coin flips are fixed: the port takes
the coin uniforms JAX draws from the round's key
(``jax.random.uniform(key, (n_pad,))``), and its colours, conflict count
and NC must then equal JAX's exactly, for a fresh NC and with the
previous round's NC threaded through ``nc_prev``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.models import mcmc_resident as jr
from mcmc_colorer_tpu.ops import hashgen as jh

from mcmc_colorer_tpu_torch.interop import adjacency_from_jax
from mcmc_colorer_tpu_torch.models import mcmc_resident as tr
from mcmc_colorer_tpu_torch.ops import dense_adj as td

torch.set_num_threads(2)

N, P, GRAPH_SEED, N_PAD = 1200, 0.04, 21, 2048


@pytest.fixture(scope="module")
def graph():
    adj_j = jh.er_packed_on_device(N, P, GRAPH_SEED, N_PAD, row_chunk=N_PAD)
    mask = np.arange(N_PAD) < N
    return adj_j, adjacency_from_jax(np.asarray(adj_j)), mask, greedy_colors()


def greedy_colors():
    """A valid first-fit colouring of the hash graph (host, in id order),
    and the neighbour lists."""
    nbrs = [[] for _ in range(N)]
    for i, j in jh.hash_edges_reference(N, P, GRAPH_SEED):
        nbrs[i].append(j)
        nbrs[j].append(i)
    colors = np.full(N, -1, np.int64)
    for v in range(N):
        used = {colors[u] for u in nbrs[v]}
        colors[v] = next(c for c in range(N) if c not in used)
    return colors, nbrs


def saturate(colors, ff, nbrs, n_colors, count):
    """Recolour one neighbour u of up to ``count`` vertices v to v's colour,
    where that leaves v with every palette colour among its neighbours:
    v and u then conflict and v has no free colour.  Pairs are kept apart
    (no touched vertex next to another pair), so v's only conflicted
    neighbour is u."""
    touched = np.zeros(N, bool)
    done = 0
    for v in range(N):
        seen = np.bincount(ff[nbrs[v]], minlength=n_colors)
        if (seen[np.arange(n_colors) != ff[v]] == 0).any():
            continue
        for u in nbrs[v]:
            near = touched[nbrs[v]].any() or touched[nbrs[u]].any()
            if seen[ff[u]] >= 2 and not near:
                colors[u] = ff[v]
                touched[[u, v]] = True
                done += 1
                break
        if done == count:
            return


def coins(key):
    return torch.from_numpy(
        np.array(jax.random.uniform(key, (N_PAD,), dtype=jnp.float32))
    )


# A valid first-fit colouring, broken in two ways.  With 38 colours (max
# degree / 2), 60 vertices are recoloured at random and every vertex keeps
# free colours.  With the first-fit palette, up to 40 vertices are left with no
# free colour, so some movers take the least-occupied colour (the fallback).
@pytest.mark.parametrize("palette", ["first_fit", 38])
def test_tailcut_rounds_match_jax(graph, palette):
    adj_j, adj_t, mask, (ff, nbrs) = graph
    n_colors = int(ff.max()) + 1 if palette == "first_fit" else palette
    rng = np.random.default_rng(n_colors)
    colors = np.full(N_PAD, n_colors, np.int32)
    colors[:N] = ff
    if palette == "first_fit":
        saturate(colors, ff, nbrs, n_colors, 40)
    else:
        colors[rng.integers(0, N, 60)] = rng.integers(0, n_colors, 60)
    mask_j, mask_t = jnp.asarray(mask), torch.from_numpy(mask)

    conf_j = jr.conflicts_from_packed(adj_j, jnp.asarray(colors), n_colors, mask_j)
    conf_t = tr.conflicts_from_packed(adj_t, torch.from_numpy(colors), n_colors, mask_t)
    assert int(conf_t) == int(conf_j) > 0

    k1, k2 = jax.random.split(jax.random.key(n_colors))
    cj, confj, ncj = jr._tailcut_nc_round(
        adj_j, jnp.asarray(colors), k1, mask_j, n_colors=n_colors
    )
    # the port's round has a chain axis: one chain here
    ct, conft, nct = (x[0] for x in tr._tailcut_nc_round(
        adj_t, torch.from_numpy(colors)[None], coins(k1)[None], mask_t, n_colors=n_colors
    ))
    moved = np.asarray(cj) != colors
    nc0 = td.neighbor_color_counts(adj_t, torch.from_numpy(colors), n_colors, mask_t)
    no_free = ((nc0 == 0) & (torch.arange(nc0.shape[1]) < n_colors)).sum(1) == 0
    assert moved.any()
    assert (moved & no_free.numpy()).any() == (palette == "first_fit")
    assert np.array_equal(ct.numpy(), np.asarray(cj))
    assert int(conft) == int(confj)
    assert np.array_equal(nct.numpy(), np.asarray(ncj))

    cj2, confj2, ncj2 = jr._tailcut_nc_round(adj_j, cj, k2, mask_j, ncj, n_colors=n_colors)
    ct2, conft2, nct2 = (x[0] for x in tr._tailcut_nc_round(
        adj_t, ct[None], coins(k2)[None], mask_t, nct[None], n_colors=n_colors
    ))
    assert np.array_equal(ct2.numpy(), np.asarray(cj2))
    assert int(conft2) == int(confj2)
    assert np.array_equal(nct2.numpy(), np.asarray(ncj2))


def test_pack_mask_matches_jax():
    rng = np.random.default_rng(0)
    for n_pad, words in [(2048, 128), (4352, 256)]:
        m = rng.random(n_pad) < 0.3
        m[-1] = True  # the last vertex lands on bit 31 of some word
        want = np.asarray(jr._pack_mask(jnp.asarray(m), words))
        got = tr._pack_mask(torch.from_numpy(m), words).numpy().view(np.uint32)
        assert np.array_equal(got, want)
