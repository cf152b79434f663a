"""The judge at BASELINE.md config 3's size, on the card: the hash-defined
ER(10^6, 0.001) of graph seed 0 derived by the reference
(``hashgraph.hash_edges``), the ELL judge (``state_ell.errors``) on an
ELL built on the card from those edges, with one row's error planted,
and 300 conflict counts (``quality.conflict_edges``), each step timed and
its peak device memory read.  ``pytest colorbench/tests -q -s -m card -k
config3`` on a machine with an NVIDIA card prints the readings as one
JSON line."""

import json
import time

import pytest
import torch

from colorbench.reference import hashgraph, quality, state_ell

from .helpers import ell_of_edges

pytestmark = pytest.mark.card

N, P, GRAPH_SEED = 1_000_000, 0.001, 0
CONFLICT_CALLS = 300


def _step(fn, device):
    """(fn's result, its seconds ended by a synchronise, its peak bytes)."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated(device)


def test_the_ell_judge_at_config3_size(card):
    (src, dst), hash_s, hash_peak = _step(lambda: hashgraph.hash_edges(N, P, GRAPH_SEED, card),
                                          card)
    deg = hashgraph.degrees(src, dst, N)
    max_deg = int(deg.max())
    ell, ell_s, ell_peak = _step(lambda: ell_of_edges(src, dst, N), card)
    alive = torch.cuda.memory_allocated(card)  # the edges and the ELL, before the judge
    err, judge_s, judge_peak = _step(lambda: state_ell.errors(ell, src, dst, N), card)
    v = int(torch.argmax(deg))
    ell[v, 0] = N  # one real neighbour of the widest row dropped
    planted, planted_s, _ = _step(lambda: state_ell.errors(ell, src, dst, N), card)
    g = torch.Generator(device=card).manual_seed(GRAPH_SEED)
    colors = torch.randint(0, max_deg, (N,), generator=g, device=card).to(torch.int16)
    counts, conflict_s, conflict_peak = _step(
        lambda: [quality.conflict_edges(colors, src, dst) for _ in range(CONFLICT_CALLS)], card)
    report = {
        "device": torch.cuda.get_device_name(card), "n": N, "p": P, "edges": src.numel(),
        "max_degree": max_deg, "ell_shape": list(ell.shape),
        "hash_edges_s": hash_s, "hash_edges_peak_bytes": hash_peak,
        "ell_build_s": ell_s, "ell_build_peak_bytes": ell_peak,
        "errors_s": judge_s, "errors_peak_bytes": judge_peak, "alive_before_errors_bytes": alive,
        "errors": err,
        "planted_errors": planted, "planted_s": planted_s,
        "conflict_calls": CONFLICT_CALLS, "conflicts_s": conflict_s,
        "conflicts_peak_bytes": conflict_peak, "conflict_edges": counts[0],
        "judge_total_s": hash_s + judge_s + conflict_s,
    }
    print("judge at config 3:", json.dumps(report), flush=True)
    assert err == 0 and planted == 1
    assert len(set(counts)) == 1 and counts[0] > 0
