"""The bucketed judge (``reference/state_bucketed.py``) on the program's
degree-bucketed layout of a small BA graph on the CPU, as the driver
reports it (``drivers/bucketed_mcmc.py:graph_state``): 0 on the sound
layout, more for one changed id, one swapped row, one phantom id and one
repeated slot; and on key lists made by hand, in bands of any size."""

import numpy as np
import pytest
import torch

from colorbench import spec
from colorbench.reference import ba_edges, state_bucketed

N, M, SEED = 2000, 8, 3


@pytest.fixture(scope="module")
def colorer():
    from mcmc_colorer_tpu_torch.config import MCMCParams
    from mcmc_colorer_tpu_torch.graph.container import Graph
    from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer

    src, dst = ba_edges.ba_edges(N, M, SEED)
    g = Graph.from_edges(N, src, dst)
    c = MCMCColorer(g, MCMCParams(n_colors=g.max_degree), layout="bucketed", device="cpu")
    c.edges = torch.from_numpy(src), torch.from_numpy(dst)
    return c


def _driver():
    return spec.driver("bucketed", "mcmc")


def _errors(colorer):
    kind, keys = _driver().graph_state(colorer)
    assert kind == "bucketed"
    return state_bucketed.errors(keys, *colorer.edges, N)


def _planted(colorer, edit):
    """The judge's count with ``edit(slices)`` applied to the layout,
    which is restored after."""
    saved = [s.neighbors.clone() for s in colorer.ell.slices]
    try:
        edit(colorer.ell.slices, colorer.ell.n_pad)
        return _errors(colorer)
    finally:
        for s, x in zip(colorer.ell.slices, saved):
            s.neighbors.copy_(x)


def _real_slot(sl, n_pad, row=0):
    return int(torch.nonzero(sl.neighbors[row] < n_pad)[0, 0])


def test_the_sound_layout_has_no_error(colorer):
    assert len(colorer.ell.slices) >= 2
    kind, keys = _driver().graph_state(colorer)
    assert keys.dtype == torch.int64 and keys.numel() == 2 * colorer.edges[0].numel()
    assert bool((keys[1:] >= keys[:-1]).all()) and int(keys.min()) >= 0
    assert _errors(colorer) == 0


def test_one_changed_id(colorer):
    def edit(slices, n_pad):
        sl = slices[0]
        k = _real_slot(sl, n_pad)
        sl.neighbors[0, k] = (sl.neighbors[0, k] + 1) % sl.n_real
    assert _errors(colorer) == 0 and _planted(colorer, edit) >= 1


def test_one_swapped_row(colorer):
    def edit(slices, n_pad):
        sl = slices[-1]
        sl.neighbors[[0, 1]] = sl.neighbors[[1, 0]].clone()
    assert _planted(colorer, edit) > 0


def test_one_phantom_id(colorer):
    def edit(slices, n_pad):
        sl = next(s for s in slices if s.h_pad > s.n_real)
        k = _real_slot(sl, n_pad, 0)
        sl.neighbors[0, k] = sl.start + sl.n_real  # the class's first phantom row
    assert _planted(colorer, edit) == 2  # the key lost, and the invalid key


def test_one_repeated_slot(colorer):
    def edit(slices, n_pad):
        # the first real row with a padding slot (a class's rows may fill it)
        sl, r = next((s, r) for s in slices for r in range(s.n_real)
                     if bool((s.neighbors[r] == n_pad).any()))
        row = sl.neighbors[r]
        free = int(torch.nonzero(row == n_pad)[0, 0])
        row[free] = row[_real_slot(sl, n_pad, r)]
    assert _planted(colorer, edit) == 1


def test_neighbor_of_names_a_neighbour_in_input_ids(colorer):
    src, dst = (t.numpy() for t in colorer.edges)
    for v in (0, 5, N - 1):
        u = _driver().neighbor_of(colorer, v)
        assert u is not None and (((src == v) & (dst == u)) | ((src == u) & (dst == v))).any()


def _keys(pairs, n):
    return torch.sort(torch.tensor([a * n + b if a >= 0 else -1 for a, b in pairs],
                                   dtype=torch.int64)).values


@pytest.mark.parametrize("band_keys", [1, 3, 1 << 24])
def test_keys_made_by_hand_in_bands_of_any_size(monkeypatch, band_keys):
    monkeypatch.setattr(state_bucketed, "BAND_KEYS", band_keys)
    n = 6
    src, dst = torch.tensor([0, 0, 2, 4], dtype=torch.int32), torch.tensor([1, 5, 3, 5],
                                                                           dtype=torch.int32)
    both = [(0, 1), (1, 0), (0, 5), (5, 0), (2, 3), (3, 2), (4, 5), (5, 4)]
    assert state_bucketed.errors(_keys(both, n), src, dst, n) == 0
    assert state_bucketed.errors(_keys(both[1:], n), src, dst, n) == 1
    assert state_bucketed.errors(_keys(both + [(-1, 0)], n), src, dst, n) == 1
    assert state_bucketed.errors(_keys(both + [(2, 3)], n), src, dst, n) == 1
    assert state_bucketed.errors(_keys(both[:-1] + [(5, 3)], n), src, dst, n) == 2
    assert state_bucketed.errors(_keys([], n), src, dst, n) == 8
    empty = torch.zeros(0, dtype=torch.int32)
    assert state_bucketed.errors(_keys([(1, 2)], n), empty, empty, n) == 1
