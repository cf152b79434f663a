"""Kernel K2 — the fused resample sweep — and its plain version.

Replaces ``mcmc_colorer_tpu/ops/pallas_resample.py:pallas_sweep``.  Per
row it reads the gathered neighbour colours ``nc`` and ids
``neighbors``, counts the conflicts of the current colour (neighbours
with a larger id only), builds the occupancy, the proposal q of
``params.proposal``, samples the inverse CDF at ``unif`` and applies the
taboo.  It returns ``(star, qstar, new_taboo, conflicts)``, conflicts as
a 0-dim int64 tensor on the device.

``resample_sweep`` dispatches on where ``nc`` lies:

- CPU tensors go to ``resample_sweep_reference``, the port of the XLA
  sweep's block function (``models/mcmc.py:_sweep``) plus the conflict
  count;
- CUDA tensors go to the hand-written kernel ``csrc/resample.cu`` (built
  with nvcc for sm_90a at first use) or raise.  There is no fallback
  from the card to the plain version.

Occupancy and conflicts are integer work and agree exactly.  The kernel
adds the float32 reminder and the CDF prefix in another order than
torch, so ``star`` may differ from the plain version's where the uniform
lies on a CDF step (``tests/test_torch_resample.py`` states the rule).
``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.ops.dense_adj import SWEEP_BLOCK_BYTES
from mcmc_colorer_tpu_torch.ops.firstfit import ROWS_PER_BLOCK, palette_ok
from mcmc_colorer_tpu_torch.ops.neighbor import occupancy_matrix
from mcmc_colorer_tpu_torch.ops.packed_nc import SMEM_BLOCK_BYTES

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "resample.cu"
_KIND_CODE = {
    ProposalKind.STANDARD: 0,
    ProposalKind.BALANCE_LINE: 1,
    ProposalKind.BALANCE_EXP: 1,
    ProposalKind.BALANCE_DYNAMIC: 1,
    ProposalKind.DECREASE_LINE: 2,
    ProposalKind.DECREASE_EXP: 2,
}

launches = 0
_built = None


def load_kernel():
    """Build (first use only) and bind the K2 library
    (``utils/cuda_build.BuiltLibrary``)."""
    global _built
    if _built is None:
        from mcmc_colorer_tpu_torch.utils.cuda_build import build_library

        built = build_library("resample", SOURCE)
        fn = built.lib.resample_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 12
            + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        err = built.lib.resample_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _built = built
    return _built


def _eps_tensor(eps, device) -> torch.Tensor:
    return torch.as_tensor(eps, dtype=torch.float32, device=device).reshape(())


def _p_eff_or_zeros(p_eff, n_colors: int, device) -> torch.Tensor:
    if p_eff is None:
        return torch.zeros((n_colors,), dtype=torch.float32, device=device)
    return p_eff


def _check(nc, neighbors, cur, taboo, self_ids, unif, p_eff, params):
    if nc.dtype != torch.int32 or nc.dim() != 2:
        raise TypeError(f"nc must be 2-D int32, got {nc.dtype} {tuple(nc.shape)}")
    if neighbors.dtype != torch.int32 or neighbors.shape != nc.shape:
        raise TypeError(f"neighbors must be int32 {tuple(nc.shape)}, got "
                        f"{neighbors.dtype} {tuple(neighbors.shape)}")
    rows = nc.shape[0]
    for name, t, dt in (("cur", cur, torch.int32), ("taboo", taboo, torch.int32),
                        ("self_ids", self_ids, torch.int32),
                        ("unif", unif, torch.float32)):
        if t.dtype != dt or t.shape != (rows,):
            raise TypeError(f"{name} must be [{rows}] {dt}, got {t.dtype} {tuple(t.shape)}")
    if p_eff.dtype != torch.float32 or p_eff.shape != (params.n_colors,):
        raise TypeError(f"p_eff must be [{params.n_colors}] float32, got "
                        f"{p_eff.dtype} {tuple(p_eff.shape)}")
    for t in (neighbors, cur, taboo, self_ids, unif, p_eff):
        if t.device != nc.device:
            raise ValueError(f"nc on {nc.device} but an argument on {t.device}")


def resample_sweep(nc, neighbors, cur, taboo, self_ids, unif, p_eff, eps,
                   params: MCMCParams):
    """One fused sweep over the rows of ``nc``: (star, qstar, new_taboo,
    conflicts).  ``p_eff`` is [n_colors] float32 (None for STANDARD)."""
    if nc.device.type == "cpu":
        return resample_sweep_reference(
            nc, neighbors, cur, taboo, self_ids, unif, p_eff, eps, params
        )
    if nc.device.type != "cuda":
        raise ValueError(f"no K2 for device {nc.device}")
    return resample_sweep_cuda(
        nc, neighbors, cur, taboo, self_ids, unif, p_eff, eps, params
    )


def resample_sweep_cuda(nc, neighbors, cur, taboo, self_ids, unif, p_eff, eps,
                        params: MCMCParams):
    """Launch K2 on the current stream of the tensors' card."""
    global launches
    n_colors = params.n_colors
    p_eff = _p_eff_or_zeros(p_eff, n_colors, nc.device)
    _check(nc, neighbors, cur, taboo, self_ids, unif, p_eff, params)
    if nc.device.type != "cuda":
        raise ValueError(f"K2 needs CUDA tensors, got {nc.device}")
    args = (nc, neighbors, cur, taboo, self_ids, unif, p_eff)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("K2 needs contiguous inputs")
    if not palette_ok(n_colors):
        raise ValueError(
            f"n_colors={n_colors}: one row's occupancy bitmask exceeds the "
            f"{SMEM_BLOCK_BYTES} bytes of shared memory a block may use"
        )
    rows, d_pad = nc.shape
    n_words = (n_colors + 31) // 32
    rows_per_block = max(1, min(ROWS_PER_BLOCK, SMEM_BLOCK_BYTES // (n_words * 4)))
    dev = nc.device
    eps_t = _eps_tensor(eps, dev)
    star = torch.empty((rows,), dtype=torch.int32, device=dev)
    qstar = torch.empty((rows,), dtype=torch.float32, device=dev)
    new_taboo = torch.empty((rows,), dtype=torch.int32, device=dev)
    conf = torch.empty((rows,), dtype=torch.int32, device=dev)
    if rows == 0:
        return star, qstar, new_taboo, conf.sum()
    lib = load_kernel().lib
    with torch.cuda.device(dev):
        rc = lib.resample_launch(
            *(t.data_ptr() for t in args), eps_t.data_ptr(),
            star.data_ptr(), qstar.data_ptr(), new_taboo.data_ptr(), conf.data_ptr(),
            rows, d_pad, n_colors, _KIND_CODE[params.proposal],
            float(params.lambda_), int(params.lambda_ == 0.0),
            params.taboo_iterations, rows_per_block,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"K2 launch failed: {lib.resample_error_string(rc).decode()} ({rc})"
        )
    launches += 1
    return star, qstar, new_taboo, conf.sum()


def resample_sweep_reference(nc, neighbors, cur, taboo, self_ids, unif, p_eff,
                             eps, params: MCMCParams, block: int | None = None):
    """Plain version of K2: per row block, ``occupancy_matrix`` and the
    proposal, sample and taboo keep of ``models/mcmc.py:_propose`` (the
    XLA sweep's block function), plus the conflict count.  Blocks bound
    the [rows, n_colors] float32 temporaries."""
    from mcmc_colorer_tpu_torch.models.mcmc import _propose

    n_colors = params.n_colors
    dev = nc.device
    p_eff = _p_eff_or_zeros(p_eff, n_colors, dev)
    _check(nc, neighbors, cur, taboo, self_ids, unif, p_eff, params)
    eps_t = _eps_tensor(eps, dev)
    rows = nc.shape[0]
    block = block or max(128, SWEEP_BLOCK_BYTES // (4 * n_colors))
    star = torch.empty((rows,), dtype=torch.int32, device=dev)
    qstar = torch.empty((rows,), dtype=torch.float32, device=dev)
    new_taboo = torch.empty((rows,), dtype=torch.int32, device=dev)
    conf = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(0, rows, block):
        e = min(s + block, rows)
        nc_b, cur_b = nc[s:e], cur[s:e]
        conf += ((nc_b == cur_b[:, None]) & (neighbors[s:e] > self_ids[s:e, None])).sum()
        star[s:e], qstar[s:e], new_taboo[s:e] = _propose(
            cur_b, occupancy_matrix(nc_b, n_colors), taboo[s:e], unif[s:e], params,
            p_eff, eps_t,
        )
    return star, qstar, new_taboo, conf
