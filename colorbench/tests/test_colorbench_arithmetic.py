"""The metrics' arithmetic, the job seeds and the kernels' work counts
against hand counts."""

import math
import statistics
import types

import numpy as np
import pytest
import torch

from colorbench import peaks, seeds, spec, stats
from colorbench.reference import quality
from colorbench.trace import Memo


def test_rate_is_over_the_whole_window():
    assert stats.rate(30, 12.0) == 2.5


def test_p95_counts_a_failed_job_as_missing():
    times = [float(i) for i in range(1, 21)]  # 20 jobs: p95 is the 19th
    assert stats.p95_with_failures(times) == 19.0
    assert stats.p95_with_failures(times[:-1] + [None]) == 19.0
    assert stats.p95_with_failures(times[:-2] + [None, None]) == math.inf
    assert stats.p95_with_failures([3.0]) == 3.0


def test_geomean_with_floor():
    assert stats.geomean([2.0, 8.0], 0.1) == pytest.approx(4.0)
    assert stats.geomean([0.0, 4.0], 1.0) == pytest.approx(2.0)


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


def test_busy_and_gaps_from_overlapping_intervals():
    iv = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0), (6.5, 6.8)]
    assert stats.union_length(iv) == pytest.approx(4.0)
    assert stats.gaps(iv, 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0), (7.0, 10.0)]
    assert stats.gaps(iv, 2.5, 6.5) == [(4.0, 6.0)]


def test_balance_index_hand_count():
    colors = np.array([0, 0, 0, 1, 2, 2])  # nCol 4: mean 1.5; colour 3 unused
    want = math.sqrt(((3 - 1.5) ** 2 + (1 - 1.5) ** 2 + (2 - 1.5) ** 2) / (6 * 0.5))
    assert quality.balance_index(colors, 4, 0.5) == pytest.approx(want)
    assert quality.balance_floor(6, 0.5) == pytest.approx(math.sqrt(2 / 3))


def test_job_seeds_are_a_function_of_seed_and_index():
    big = 2**31 + 12345
    assert seeds.graph_seed(big, 3) == seeds.graph_seed(big, 3)
    assert seeds.chain_seed(big) == seeds.chain_seed(big)
    assert len({seeds.graph_seed(big, j) for j in range(200)}) == 200
    assert seeds.graph_seed(big, 0) != seeds.graph_seed(big + 2**32, 0)
    assert len({seeds.graph_seed(big, 0), seeds.chain_seed(big), seeds.warm_seed(big),
                seeds.sample_seed(big)}) == 4
    assert all(0 <= seeds.derive(big, "x", j) < 2**32 for j in range(50))


def test_bound_is_the_larger_of_bytes_and_operations():
    assert peaks.bound_s(3.35e12, 0, 1e12) == pytest.approx(1.0)
    assert peaks.bound_s(0, 2e12, 1e12) == pytest.approx(2.0)


def _args(**kw):
    return kw


def test_k1_work_hand_count():
    k1 = spec.roofline("k1")
    # 4 rows, 1 word each (uint32 patterns): degrees 1, 2, 0, 32
    packed = torch.tensor([[1], [3], [0], [-1]], dtype=torch.int32)
    colors = torch.tensor([0, 5, 1, -1], dtype=torch.int32)  # 5 is outside n_col_pad 4
    n_bytes, ops = k1.work((packed, colors, 4), {}, Memo())
    assert n_bytes == 4 * 4 + 4 * 4 + 1 * 4 * 4 * 4
    assert int(ops) == 1 + 0 + 0 + 0  # in-range colours at rows 0 and 2 only
    chains = torch.stack([colors, torch.tensor([0, 1, 2, 3], dtype=torch.int32)])
    _, ops2 = k1.work((packed, chains, 4), {}, Memo())
    assert int(ops2) == 1 + (1 + 2 + 0 + 32)


def test_k2_work_hand_count():
    k2 = spec.roofline("k2")
    neigh = torch.tensor([[1, 2, 9], [0, 9, 9]], dtype=torch.int32)  # 3 real slots, 9 = padding
    colors = torch.zeros(4, dtype=torch.int32)
    v = torch.zeros(2, dtype=torch.int32)
    params = types.SimpleNamespace(n_colors=5)
    n_bytes, ops = k2.work((neigh, colors, v, v, 0, v.float(), None, None, params), {}, Memo())
    assert int(n_bytes) == 24 + 3 * 8 + 3 * 4 + 4 * 5 + 2 * 12 + 8
    assert ops == 2 * (3 + 5)


def test_k3_work_hand_count():
    k3 = spec.roofline("k3")
    neigh = torch.tensor([[1, 2, 9], [0, 9, 9]], dtype=torch.int32)
    colors = torch.zeros(2, dtype=torch.int32)  # ids below 2 are real: 1 and 0
    allow = torch.ones(5, dtype=torch.int32)
    cur = torch.zeros(2, dtype=torch.int32)
    n_bytes, ops = k3.work((neigh, colors, allow, 5), {"cur": cur}, Memo())
    # ids, allow, cur, the answer (4 a row), the 2 colours the real slots name
    assert int(n_bytes) == 24 + 20 + 8 + 2 * 4 + 2 * 4
    assert int(ops) == 2


def test_k4_work_hand_count():
    k4 = spec.roofline("k4")
    c, rows, n_col_pad = 2, 3, 128
    nc = torch.zeros((c, rows, n_col_pad), dtype=torch.int32)
    v = torch.zeros((c, rows), dtype=torch.int32)
    real = torch.ones(rows, dtype=torch.bool)
    p_eff = torch.zeros((c, 10), dtype=torch.float32)
    params = types.SimpleNamespace(n_colors=10)  # read as 12 colours: 16-byte copies
    n_bytes, ops = k4.work((nc, v, v, v.float(), real, p_eff, None, params), {}, Memo())
    # NC's palette columns, six [C, rows] vectors of 4 bytes, real, p_eff, conf2
    assert n_bytes == 4 * c * rows * 12 + 6 * 4 * c * rows + rows + 4 * c * 10 + 8 * c
    assert ops == 0
    n_bytes, _ = k4.work((nc[:1], v[:1], v[:1], v[:1].float(), real, None, None, params), {},
                         Memo())
    assert n_bytes == 4 * rows * 12 + 6 * 4 * rows + rows + 8


def test_memo_holds_a_value_while_its_tensor_lives():
    m, calls = Memo(), []
    t = torch.arange(10)
    for _ in range(3):
        m.get(t[2:5], "k", lambda: calls.append(1) or 7)
    assert calls == [1]
    u = torch.arange(10)
    m.get(u[2:5], "k", lambda: calls.append(1) or 7)
    assert calls == [1, 1]
