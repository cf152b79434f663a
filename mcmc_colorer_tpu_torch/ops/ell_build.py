"""ELL rectangle built on the device from the O(2m + n) CSR.

Counterpart of ``mcmc_colorer_tpu/ops/ell_build.py``.  The host ships
what the reference ships at its host-to-device boundary, ``row_ptr``
(n + 1 words) and ``cols`` (2m words), and the [n_pad, d_pad] rectangle
is scattered on the device: for each edge slot k of a band, its row is
``searchsorted(row_ptr, k, right=True) - 1`` (empty rows are skipped,
as their boundaries repeat), its slot ``k - row_ptr[row]``, and
``ell[row, slot] = cols[k]``.  Bit-equal to the host build of
``Graph.to_ell`` (by test).

``cols`` is copied band by band, so the device holds the rectangle plus
one band of cols and its int64 edge, row, slot and flat-index arrays
(~36 bytes an edge, ~1.2 GB at the default band).
"""

from __future__ import annotations

import time

import numpy as np
import torch

ELL_BUILD_BAND_EDGES = 32 * 1024 * 1024


def ell_neighbors_from_csr_device(
    row_ptr: np.ndarray,
    cols: np.ndarray,
    n_pad: int,
    d_pad: int,
    device="cpu",
    stats: dict | None = None,
    band_edges: int = ELL_BUILD_BAND_EDGES,
    sentinel: int | None = None,
) -> torch.Tensor:
    """[n_pad, d_pad] int32 neighbour rectangle on ``device`` (``sentinel``,
    by default ``n_pad``, in padding slots), scattered from the CSR.  A
    shard's rows (``parallel/sharded.py``) pass their slice of the CSR,
    rebased to 0, with the global padding id as ``sentinel``."""
    device = torch.device(device)
    m2 = int(cols.shape[0])
    if n_pad * d_pad >= 2**63 or n_pad > 2**31 - 1:
        raise ValueError(f"rectangle [{n_pad}, {d_pad}] outside int32 ids")
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    cum = torch.from_numpy(np.ascontiguousarray(row_ptr, dtype=np.int64)).to(device)
    fill = n_pad if sentinel is None else sentinel
    ell = torch.full((n_pad, d_pad), fill, dtype=torch.int32, device=device)
    flat = ell.view(-1)
    cols_c = np.ascontiguousarray(cols, dtype=np.int32)
    bands = 0
    for e0 in range(0, m2, band_edges):
        e1 = min(e0 + band_edges, m2)
        seg = torch.from_numpy(cols_c[e0:e1]).to(device, non_blocking=False)
        k = torch.arange(e0, e1, dtype=torch.int64, device=device)
        row = torch.searchsorted(cum, k, right=True) - 1
        slot = k - cum[row]
        flat[row * d_pad + slot] = seg
        bands += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats["build_s"] = time.perf_counter() - t0
    stats["upload_bytes"] = int(cum.numel() * 8 + m2 * 4)
    stats["bands"] = bands
    return ell
