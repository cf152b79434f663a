"""Erdős–Rényi and Barabási–Albert graph generation (host, numpy).

Counterpart of ``mcmc_colorer_tpu/graph/generate.py``: the same
samplers, so the same seed gives the same CSR in both packages.  ER
graphs are sampled with geometric skips over the linearised upper
triangle (O(E) work); above 20M expected edges (BA: 500k) the C++
samplers of ``graph/native.py`` build the CSR in one pass.  The two
samplers draw different (equally valid) streams.
"""

from __future__ import annotations

import logging

import numpy as np

from mcmc_colorer_tpu_torch.graph.container import Graph

_log = logging.getLogger("mcmc_colorer_tpu_torch.generate")


def _linear_to_triu(idx: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Map linear indices over the strict upper triangle (row-major:
    (0,1),(0,2)…(0,n-1),(1,2)…) of an n×n matrix to (i, j) pairs.  Row i
    starts at S(i) = i(2n - i - 1)/2; i is the largest with S(i) <= idx."""
    idx = idx.astype(np.float64)
    i = np.floor(
        ((2 * n - 1) - np.sqrt((2 * n - 1) ** 2 - 8 * idx)) / 2
    ).astype(np.int64)
    # guard against float rounding at row boundaries
    s = i * (2 * n - i - 1) // 2
    i = i - (s > idx.astype(np.int64)).astype(np.int64)
    s = i * (2 * n - i - 1) // 2
    j = (idx.astype(np.int64) - s) + i + 1
    return i, j


def erdos_renyi(
    n: int,
    p: float,
    seed: int = 0,
    name: str | None = None,
    use_native: bool | None = None,
) -> Graph:
    """Sample G(n, p): every upper-triangle slot is an independent
    Bernoulli(p), reached by geometric inter-arrival skips."""
    if not (0.0 <= p <= 1.0):
        raise ValueError(f"p must be in [0,1], got {p}")
    expected_m = n * (n - 1) / 2 * p
    if use_native or (use_native is None and expected_m > 20_000_000):
        from mcmc_colorer_tpu_torch.graph import native

        _log.info("erdos_renyi(n=%d, p=%g, seed=%d): native C++ sampler", n, p, seed)
        g = native.generate_er(n, p, seed=seed, name=name or f"er_{n}_{p}")
        g.simple_certified = True
        return g
    total = n * (n - 1) // 2
    rng = np.random.default_rng(seed)
    if p == 0.0 or total == 0:
        src = dst = np.empty(0, dtype=np.int64)
    elif p >= 1.0:
        src, dst = _linear_to_triu(np.arange(total, dtype=np.int64), n)
    else:
        # draw geometric skips in chunks until we pass `total`
        log1mp = np.log1p(-p)
        est = int(total * p * 1.1) + 1024
        positions = []
        pos = -1
        while pos < total:
            u = rng.random(est)
            skips = np.floor(np.log(u) / log1mp).astype(np.int64) + 1
            chunk = np.cumsum(skips) + pos
            positions.append(chunk)
            pos = int(chunk[-1])
            est = max(1024, int((total - pos) * p * 1.1) + 1024)
        idx = np.concatenate(positions)
        src, dst = _linear_to_triu(idx[idx < total], n)
    g = Graph.from_edges(n, src, dst, name=name or f"er_{n}_{p}")
    g.simple_certified = True  # each slot is drawn at most once
    return g


def barabasi_albert(
    n: int,
    m_per_node: int,
    seed: int = 0,
    name: str | None = None,
    use_native: bool | None = None,
) -> Graph:
    """Preferential attachment: each new vertex attaches to
    ``m_per_node`` distinct existing vertices drawn from the repeated-stubs
    list (degree-proportional)."""
    if m_per_node < 1 or n <= m_per_node:
        raise ValueError("need n > m_per_node >= 1")
    if use_native or (use_native is None and n * m_per_node > 500_000):
        from mcmc_colorer_tpu_torch.graph import native

        _log.info("barabasi_albert(n=%d, m=%d, seed=%d): native C++ sampler",
                  n, m_per_node, seed)
        g = native.generate_ba(n, m_per_node, seed=seed,
                               name=name or f"ba_{n}_{m_per_node}")
        g.simple_certified = True
        return g
    rng = np.random.default_rng(seed)
    m0 = m_per_node + 1
    n_edges = m0 * (m0 - 1) // 2 + (n - m0) * m_per_node
    src = np.empty(n_edges, dtype=np.int64)
    dst = np.empty(n_edges, dtype=np.int64)
    stubs = np.empty(2 * n_edges + m0, dtype=np.int64)
    stubs[:m0] = np.arange(m0)
    e, s = 0, m0
    for v in range(m0):
        for w in range(v + 1, m0):
            src[e], dst[e] = v, w
            e += 1
            stubs[s], stubs[s + 1] = v, w
            s += 2
    for v in range(m0, n):
        targets: set[int] = set()
        while len(targets) < m_per_node:
            # draw a batch; dedup keeps the accepted prefix
            picks = stubs[rng.integers(0, s, size=2 * m_per_node)]
            for t in picks:
                targets.add(int(t))
                if len(targets) == m_per_node:
                    break
        for t in targets:
            src[e], dst[e] = v, t
            e += 1
            stubs[s], stubs[s + 1] = v, t
            s += 2
    g = Graph.from_edges(n, src, dst, name=name or f"ba_{n}_{m_per_node}")
    g.simple_certified = True  # per-vertex targets are distinct
    return g


def random_node_names(
    n: int, rng: np.random.Generator | None = None, length: int = 12
) -> list[str]:
    """Random alphanumeric node names, as datasetGen emits."""
    rng = rng or np.random.default_rng(10000)  # fixed seed like the reference
    alphabet = np.array(
        list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789")
    )
    picks = rng.integers(0, len(alphabet), size=(n, length))
    return ["".join(row) for row in alphabet[picks]]
