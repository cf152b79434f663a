"""Kernel K6's wrapper and the hash graph's packed generators around it
(``ops/hash_packed.py``, ``ops/hashgen.py``).

On the CPU every generator takes the plain version and K6 never launches;
the wrapper checks what it is given before any launch; the cached
(A, degrees) pair is one build; a strip comes with its rows' degrees.  The cases marked ``card`` hold K6 on the
card (``python -m pytest --noconftest -m card
tests/test_torch_hash_packed.py``; this file imports no JAX) bit for bit
against the plain version, words and degrees, at n off 128 and 4096 with
phantom rows, row windows that start mid-A, p = 0, 0.001, 0.5 and 1 and
seeds with bit 31 set, with one launch a build.
"""

import pytest
import torch

from mcmc_colorer_tpu_torch.ops import hash_packed as k6
from mcmc_colorer_tpu_torch.ops import hashgen
from mcmc_colorer_tpu_torch.ops.dense_adj import packed_adj_words
from mcmc_colorer_tpu_torch.parallel.mesh import Mesh

from torch_card import card  # noqa: F401  (the fixture)

torch.set_num_threads(2)


def _plain(r0, rows, n, p, seed, words, device):
    out = torch.empty((rows, words), dtype=torch.int32, device=device)
    deg = torch.empty((rows,), dtype=torch.int32, device=device)
    hashgen.gen_packed_rows_plain(r0, n, hashgen.er_threshold(p), seed & 0xFFFFFFFF, words,
                                  out, deg, row_chunk=256)
    return out, deg


def test_cpu_builds_take_the_plain_version_and_never_launch():
    before = k6.launches
    n, p, seed, n_pad = 700, 0.03, 2**31 + 13, 768
    adj, deg = hashgen.er_packed_and_degrees(n, p, seed, n_pad, row_chunk=256, device="cpu")
    want, want_deg = _plain(0, n_pad, n, p, seed, packed_adj_words(n_pad), "cpu")
    assert torch.equal(adj, want) and torch.equal(deg, want_deg)
    assert torch.equal(deg, hashgen.degrees_from_packed(adj))
    assert torch.equal(hashgen.er_packed_on_device(n, p, seed, n_pad, row_chunk=128,
                                                   device="cpu"), want)
    assert torch.equal(hashgen.er_degrees_on_device(n, p, seed, row_chunk=96, device="cpu"),
                       want_deg[:n])
    strip, strip_deg = hashgen.er_packed_strips_on_device(n, p, seed, n_pad,
                                                          Mesh(1, 3, 0, 2, torch.device("cpu")),
                                                          row_chunk=100)
    assert torch.equal(strip, want[512:]) and torch.equal(strip_deg, want_deg[512:])
    assert k6.launches == before


@pytest.mark.parametrize("r0, rows", [(0, 100), (250, 37), (600, 168)])
def test_a_window_of_plain_rows_is_the_whole_builds(r0, rows):
    """Rows [r0, r0 + rows) built alone (as a strip or a band) equal those
    rows of the whole A, with their degrees; degrees alone the same."""
    n, p, seed, n_pad = 700, 0.05, 5, 768
    words = packed_adj_words(n_pad)
    whole, whole_deg = _plain(0, n_pad, n, p, seed, words, "cpu")
    out, deg = _plain(r0, rows, n, p, seed, words, "cpu")
    assert torch.equal(out, whole[r0:r0 + rows]) and torch.equal(deg, whole_deg[r0:r0 + rows])
    alone = torch.empty((rows,), dtype=torch.int32)
    hashgen._gen_packed_rows(r0, n, hashgen.er_threshold(p), seed, words, degrees=alone,
                             row_chunk=64)
    assert torch.equal(alone, deg)


def test_the_cached_pair_is_one_build(monkeypatch):
    monkeypatch.setattr(hashgen, "_PACKED_CACHE", {})
    builds = []
    build = hashgen.er_packed_and_degrees
    monkeypatch.setattr(hashgen, "er_packed_and_degrees",
                        lambda *a, **k: builds.append(a) or build(*a, **k))
    adj, deg = hashgen.er_packed_on_device_cached(300, 0.05, 1, 512, row_chunk=256, device="cpu")
    again = hashgen.er_packed_on_device_cached(300, 0.05, 1, 512, row_chunk=256, device="cpu")
    assert again[0] is adj and again[1] is deg and len(builds) == 1
    assert torch.equal(deg, hashgen.degrees_from_packed(adj))


def _i32(rows, words):
    return torch.zeros((rows, words), dtype=torch.int32)


@pytest.mark.parametrize("call, err", [
    (lambda: k6.hash_packed_cuda(0, 10, 5, 1), ValueError),                      # no output
    (lambda: k6.hash_packed_cuda(0, 10, 5, 1, _i32(4, 100)), ValueError),        # words % 128
    (lambda: k6.hash_packed_cuda(0, 5000, 5, 1, _i32(4, 128)), ValueError),      # n past the columns
    (lambda: k6.hash_packed_cuda(-1, 10, 5, 1, _i32(4, 128)), ValueError),       # r0 < 0
    (lambda: k6.hash_packed_cuda(2**31 - 2, 10, 5, 1, _i32(4, 128)), ValueError),  # ids past int32
    (lambda: k6.hash_packed_cuda(0, -1, 5, 1, _i32(4, 128)), ValueError),        # n < 0
    (lambda: k6.hash_packed_cuda(0, 10, 2**32, 1, _i32(4, 128)), ValueError),    # t past uint32
    (lambda: k6.hash_packed_cuda(0, 10, 5, 1, _i32(4, 128),
                                 torch.zeros(3, dtype=torch.int32)), ValueError),  # degrees' rows
    (lambda: k6.hash_packed_cuda(0, 10, 5, 1, _i32(4, 128).long()), TypeError),
    (lambda: k6.hash_packed_cuda(0, 10, 5, 1, _i32(4, 256)[:, ::2]), TypeError),  # not contiguous
    (lambda: k6.hash_packed_cuda(0, 10, 5, 1, _i32(4, 128)), ValueError),        # not on a card
    (lambda: hashgen._gen_packed_rows(0, 10, 5, 1, 128,
                                      torch.empty((4, 128), dtype=torch.int32, device="meta")),
     ValueError),
], ids=["no_output", "words_not_windows", "n_past_columns", "negative_r0", "ids_past_int32",
        "negative_n", "threshold_past_uint32", "degrees_rows", "int64", "strided", "cpu", "meta"])
def test_k6_checks_before_any_launch(call, err):
    before = k6.launches
    with pytest.raises(err):
        call()
    assert k6.launches == before


@pytest.mark.card
@pytest.mark.parametrize("n, p, seed, n_pad, r0, rows", [
    (5000, 0.001, 7, 6144, 0, 6144),            # n off 128 and 4096, phantom rows
    (4097, 0.5, 2**31 + 11, 4224, 0, 4224),     # one column into the second window
    (300, 0.0, 1, 384, 0, 384),                 # no edge at all
    (3000, 1.0, 2**32 - 5, 3072, 0, 3072),      # every pair but h = 2**32 - 1
    (9000, 0.01, 2**31 + 1, 10240, 4090, 1001),  # a window mid-A across the diagonal windows
    (9000, 0.5, 3, 10240, 8960, 1280),          # a window into the phantom rows
    (20000, 0.01, 0, 20480, 6, 33),             # a few rows, off the tile
])
def test_kernel_is_the_plain_version_bit_for_bit(card, n, p, seed, n_pad, r0, rows):
    words = packed_adj_words(n_pad)
    t, s32 = hashgen.er_threshold(p), seed & 0xFFFFFFFF
    want, want_deg = _plain(r0, rows, n, p, seed, words, card)
    out = torch.full((rows, words), -1, dtype=torch.int32, device=card)
    deg = torch.full((rows,), -1, dtype=torch.int32, device=card)
    before = k6.launches
    hashgen._gen_packed_rows(r0, n, t, s32, words, out, deg)
    assert k6.launches == before + 1
    only_words = torch.full_like(out, -1)
    hashgen._gen_packed_rows(r0, n, t, s32, words, only_words)
    only_deg = torch.full_like(deg, -1)
    hashgen._gen_packed_rows(r0, n, t, s32, words, degrees=only_deg)
    assert k6.launches == before + 3
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(deg, want_deg)
    assert torch.equal(only_words, want) and torch.equal(only_deg, want_deg)


@pytest.mark.card
def test_the_generators_take_k6_once(card, monkeypatch):
    """``er_packed_and_degrees`` builds A and its degrees in one launch,
    ``er_packed_on_device`` A alone in one, the cache's pair is one build,
    a strip and its rows' degrees are one launch, the degrees alone
    another; each equals the plain version's."""
    n, p, seed, n_pad = 30000, 0.01, 2**31 + 7, 30720
    want, want_deg = hashgen.er_packed_plain(n, p, seed, n_pad, device=card)
    before = k6.launches
    adj, deg = hashgen.er_packed_and_degrees(n, p, seed, n_pad, device=card)
    assert k6.launches == before + 1
    assert torch.equal(adj, want) and torch.equal(deg, want_deg)
    assert torch.equal(hashgen.er_packed_on_device(n, p, seed, n_pad, device=card), want)
    assert k6.launches == before + 2
    monkeypatch.setattr(hashgen, "_PACKED_CACHE", {})
    adj2, deg2 = hashgen.er_packed_on_device_cached(n, p, seed, n_pad, device=card)
    assert hashgen.er_packed_on_device_cached(n, p, seed, n_pad, device=card)[0] is adj2
    assert k6.launches == before + 3
    assert torch.equal(adj2, want) and torch.equal(deg2, want_deg)
    strip, strip_deg = hashgen.er_packed_strips_on_device(n, p, seed, n_pad,
                                                          Mesh(1, 4, 0, 3, card))
    assert k6.launches == before + 4
    assert torch.equal(strip, want[3 * n_pad // 4:])
    assert torch.equal(strip_deg, want_deg[3 * n_pad // 4:])
    assert torch.equal(hashgen.er_degrees_on_device(n, p, seed, device=card), want_deg[:n])
    assert k6.launches == before + 5
