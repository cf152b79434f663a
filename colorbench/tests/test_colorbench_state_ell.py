"""The ELL judge (``reference/state_ell.py``, torch on the judge's device)
against the NumPy judge it replaced, kept here as the oracle, on small
random graphs with planted faults; and the tests' ELL builder held to
the same oracle."""

import numpy as np
import pytest
import torch

from colorbench.reference import er_edges, state_ell

from .helpers import ell_of_edges


def oracle_errors(neighbors, src, dst, n: int) -> int:
    """The NumPy judge: each row's ids sorted (padding any id >= n, as n)
    against the reference's CSR row, plus the rows wider than the ELL."""
    rows = neighbors[:n].cpu().numpy().astype(np.int64)
    rows = np.sort(np.where(rows >= n, n, rows), axis=1)
    row_ptr, cols = er_edges.csr(n, src.cpu().numpy(), dst.cpu().numpy())
    width = rows.shape[1]
    deg = np.diff(row_ptr)
    want = np.full((n, max(width, 1)), n, np.int64)
    fits = deg <= width
    r = np.repeat(np.arange(n), deg)
    k = np.arange(cols.size) - np.repeat(row_ptr[:-1], deg)
    keep = fits[r]
    want[r[keep], k[keep]] = cols[keep]
    return int(((rows != want[:, :width]).any(1) | ~fits).sum())


def _graph(n, p, seed):
    s, d = er_edges.er_edges(n, p, seed)
    return torch.from_numpy(s), torch.from_numpy(d)


def _both(ell, src, dst, n):
    return state_ell.errors(ell, src, dst, n), oracle_errors(ell, src, dst, n)


def _rows_with_degree(ell, n, at_least):
    deg = (ell[:n] < n).sum(1)
    return torch.nonzero(deg >= at_least)[:, 0].tolist()


GRAPHS = [(300, 0.05, 3), (517, 0.02, 2**33 + 1), (64, 0.5, 9)]


@pytest.mark.parametrize("n,p,seed", GRAPHS)
def test_the_ell_of_the_edges_has_no_error(n, p, seed):
    src, dst = _graph(n, p, seed)
    ell = ell_of_edges(src, dst, n, seed=seed)
    assert ell.dtype == torch.int32 and ell.shape[1] % 32 == 0
    assert _both(ell, src, dst, n) == (0, 0)
    # padded to n rows more, and padding ids above n: still no error
    wide = torch.cat([ell, torch.full((5, ell.shape[1]), n + 7, dtype=torch.int32)])
    wide[wide == n] = n + 3
    assert _both(wide, src, dst, n) == (0, 0)


@pytest.mark.parametrize("n,p,seed", GRAPHS)
def test_planted_faults_are_counted_exactly(n, p, seed):
    src, dst = _graph(n, p, seed)
    ell = ell_of_edges(src, dst, n, seed=seed)
    g = torch.Generator().manual_seed(seed)
    rows = _rows_with_degree(ell, n, 2)
    pick = [rows[int(i)] for i in torch.randperm(len(rows), generator=g)[:4]]

    dropped = ell.clone()  # a real entry dropped from one row
    k = int(torch.nonzero(dropped[pick[0]] < n)[0, 0])
    dropped[pick[0], k] = n
    assert _both(dropped, src, dst, n) == (1, 1)

    extra = ell.clone()  # an id that is no neighbour added to two rows
    for v in pick[:2]:
        nb = set(extra[v][extra[v] < n].tolist()) | {v}
        free = int(torch.nonzero(extra[v] >= n)[0, 0])
        extra[v, free] = next(u for u in range(n) if u not in nb)
    assert _both(extra, src, dst, n) == (2, 2)

    swapped = ell.clone()  # two rows of different neighbour sets swapped
    a, b = pick[2], pick[3]
    swapped[[a, b]] = swapped[[b, a]]
    assert _both(swapped, src, dst, n) == (2, 2)

    narrow_width = int((ell[:n] < n).sum(1).max()) - 1  # the widest rows no longer fit
    narrow = ell_of_edges(src, dst, n, width=narrow_width, seed=seed)
    want = int(((ell[:n] < n).sum(1) > narrow_width).sum())
    assert want >= 1 and _both(narrow, src, dst, n) == (want, want)


def test_a_negative_id_and_a_duplicate_are_errors():
    n = 200
    src, dst = _graph(n, 0.05, 4)
    ell = ell_of_edges(src, dst, n)
    rows = _rows_with_degree(ell, n, 2)
    bad = ell.clone()
    bad[rows[0], int(torch.nonzero(bad[rows[0]] >= n)[0, 0])] = -1
    row = bad[rows[1]]
    row[1] = row[0]
    assert _both(bad, src, dst, n) == (2, 2)


def test_a_graph_with_no_edges_and_an_ell_of_no_width():
    n = 40
    empty = torch.zeros(0, dtype=torch.int32)
    assert _both(torch.full((n, 0), n, dtype=torch.int32), empty, empty, n) == (0, 0)
    src, dst = torch.tensor([0, 3], dtype=torch.int32), torch.tensor([5, 9], dtype=torch.int32)
    assert _both(torch.full((n, 0), n, dtype=torch.int32), src, dst, n) == (4, 4)


def test_bands_of_one_row_give_the_same_count(monkeypatch):
    n = 150
    src, dst = _graph(n, 0.06, 12)
    ell = ell_of_edges(src, dst, n, seed=1)
    ell[7, 0], ell[8, 0] = ell[8, 0].clone(), ell[7, 0].clone()
    want = oracle_errors(ell, src, dst, n)
    monkeypatch.setattr(state_ell, "BAND_ELEMENTS", 1)
    assert state_ell.errors(ell, src, dst, n) == want


def test_bands_of_a_few_rows_count_faults_at_their_edges(monkeypatch):
    n = 150
    src, dst = _graph(n, 0.06, 13)
    ell = ell_of_edges(src, dst, n, seed=2)
    monkeypatch.setattr(state_ell, "BAND_ELEMENTS", 7 * ell.shape[1])  # bands of 7 rows
    ell[6, 0], ell[7, 0] = ell[7, 0].clone(), ell[6, 0].clone()  # the last and first rows of two
    ell[n - 1] = n  # the last row of the last, short band emptied
    want = oracle_errors(ell, src, dst, n)
    assert want >= 2 and state_ell.errors(ell, src, dst, n) == want
