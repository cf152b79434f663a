"""Kernel K4 — the proposal over neighbour-colour counts — and its plain
version.

The packed chain's sweep (``models/mcmc.py:_sweep_matmul``) and the
sharded strips (``parallel/sharded.py``) read the proposal of C chains'
rows from their NC [C, rows, n_col_pad]: the occupancy NC > 0, the
proposal q of ``params.proposal``, the inverse-CDF sample at ``unif``,
qstar and the taboo step (``models/mcmc.py:_propose``), with rows outside
``real`` keeping their colour at qstar 1, and beside it conf2 [C] =
Σ_i NC[i, cur_i], twice the conflict edges of ``cur`` where the rows are
a whole A's.  ``propose_nc`` returns (star, new_taboo, Σ log qstar [C],
conf2) and dispatches on where ``nc`` lies:

- CPU tensors go to ``propose_nc_plain``: ``_propose`` a chain at a time
  in row blocks of ``block`` rows, with ``p_eff`` zero-padded to NC's
  width;
- CUDA tensors go to ``propose_nc_cuda``, the hand-written kernel
  ``csrc/propose_nc.cu`` (built with nvcc for sm_90a at first use), one
  launch for all chains, then Σ log qstar as one torch reduction; or
  raise.  There is no fallback from the card to the plain version.  The
  kernel stages each row in shared memory up to ``N_COL_PAD_STAGED``
  padded colours and reads it in place above; it takes no palette wider
  than ``N_COL_PAD_MAX`` (its p_eff no longer fits a block's shared
  memory).  It reads the first n_colors columns of NC only: the columns
  past them are K1's padding, 0 in every row.

It replaces no Pallas kernel: the JAX package computes the same step in
jnp (``mcmc_colorer_tpu/models/mcmc.py``: ``_proposal_q``,
``_sample_cdf``).  The kernel adds the float32 reminder and the CDF
prefix in another order than torch, so ``star`` may differ from the plain
version's where the uniform lies on a CDF step; conf2 is exact.
``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.ops.resample import _KIND_CODE, _eps_tensor

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "propose_nc.cu"

# widest padded palettes whose rows K4 stages in shared memory, and that
# it takes at all (csrc/propose_nc.cu:propose_nc_launch)
N_COL_PAD_STAGED = 28_800
N_COL_PAD_MAX = 57_984

launches = 0
_built = None


def load_kernel():
    """Build (first use only) and bind the K4 library
    (``utils/cuda_build.BuiltLibrary``)."""
    global _built
    if _built is None:
        from mcmc_colorer_tpu_torch.utils.cuda_build import build_library

        built = build_library("propose_nc", SOURCE)
        fn = built.lib.propose_nc_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_float]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        err = built.lib.propose_nc_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _built = built
    return _built


def _check(nc, cur, taboo, unif, real, p_eff, params: MCMCParams):
    if nc.dtype != torch.int32 or nc.dim() != 3:
        raise TypeError(f"nc must be [C, rows, n_col_pad] int32, got {nc.dtype} "
                        f"{tuple(nc.shape)}")
    c, rows, n_col_pad = nc.shape
    if not 1 <= params.n_colors <= n_col_pad:
        raise ValueError(f"n_colors={params.n_colors} outside [1, {n_col_pad}]")
    args = [("cur", cur, torch.int32, (c, rows)), ("taboo", taboo, torch.int32, (c, rows)),
            ("unif", unif, torch.float32, (c, rows)), ("real", real, torch.bool, (rows,))]
    if p_eff is not None:
        args.append(("p_eff", p_eff, torch.float32, (c, params.n_colors)))
    elif params.proposal != ProposalKind.STANDARD:
        raise ValueError(f"{params.proposal} needs p_eff")
    for name, t, dt, shape in args:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise TypeError(f"{name} must be {list(shape)} {dt}, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != nc.device:
            raise ValueError(f"nc lies on {nc.device} but {name} on {t.device}")


def propose_nc(nc, cur, taboo, unif, real, p_eff, eps, params: MCMCParams, block: int):
    """The proposal of C chains' rows from their NC [C, rows, n_col_pad]
    (``cur``, ``taboo``, ``unif`` [C, rows], ``real`` [rows] bool,
    ``p_eff`` [C, n_colors] float32 or None for STANDARD, ``eps`` a
    float32 scalar): (star, new_taboo, Σ log qstar [C], conf2 [C] int64).
    ``block`` is the plain version's rows a block."""
    if nc.device.type == "cpu":
        return propose_nc_plain(nc, cur, taboo, unif, real, p_eff, eps, params, block)
    if nc.device.type != "cuda":
        raise ValueError(f"no K4 for device {nc.device}")
    star, new_taboo, qstar, conf2 = propose_nc_cuda(nc, cur, taboo, unif, real, p_eff, eps,
                                                    params)
    return star, new_taboo, torch.log(qstar.clamp(min=1e-30)).sum(1), conf2


def propose_nc_cuda(nc, cur, taboo, unif, real, p_eff, eps, params: MCMCParams):
    """Launch K4 on the current stream of the tensors' card: (star,
    new_taboo, qstar [C, rows], conf2 [C])."""
    global launches
    _check(nc, cur, taboo, unif, real, p_eff, params)
    c, rows, n_col_pad = nc.shape
    if n_col_pad > N_COL_PAD_MAX:
        raise ValueError(f"K4 stages p_eff in a block's shared memory: n_col_pad={n_col_pad} "
                         f"is above its {N_COL_PAD_MAX}")
    if nc.device.type != "cuda":
        raise ValueError(f"K4 needs CUDA tensors, got {nc.device}")
    args = (nc, cur, taboo, unif, real) + (() if p_eff is None else (p_eff,))
    if not all(t.is_contiguous() for t in args):
        raise ValueError("K4 needs contiguous inputs")
    if n_col_pad % 128 or nc.data_ptr() % 16:
        raise ValueError(f"K4 copies NC rows in 16-byte vectors, 32 colours a lane: "
                         f"n_col_pad={n_col_pad} must be a multiple of 128 and nc 16-byte "
                         f"aligned")
    dev = nc.device
    eps_t = _eps_tensor(eps, dev)
    star = torch.empty((c, rows), dtype=torch.int32, device=dev)
    new_taboo = torch.empty((c, rows), dtype=torch.int32, device=dev)
    qstar = torch.empty((c, rows), dtype=torch.float32, device=dev)
    conf2 = torch.zeros((c,), dtype=torch.int64, device=dev)
    if c == 0 or rows == 0:
        return star, new_taboo, qstar, conf2
    lib = load_kernel().lib
    with torch.cuda.device(dev):
        rc = lib.propose_nc_launch(
            nc.data_ptr(), cur.data_ptr(), taboo.data_ptr(), unif.data_ptr(), real.data_ptr(),
            None if p_eff is None else p_eff.data_ptr(), eps_t.data_ptr(), star.data_ptr(),
            new_taboo.data_ptr(), qstar.data_ptr(), conf2.data_ptr(), rows, n_col_pad,
            params.n_colors, _KIND_CODE[params.proposal], float(params.lambda_),
            int(params.lambda_ == 0.0), params.taboo_iterations, c,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"K4 launch failed: {lib.propose_nc_error_string(rc).decode()} ({rc})"
        )
    launches += 1
    return star, new_taboo, qstar, conf2


def propose_nc_plain(nc, cur, taboo, unif, real, p_eff, eps, params: MCMCParams, block: int):
    """Plain version of K4: a chain at a time in row blocks, ``_propose`` on
    the occupancy NC > 0 with ``p_eff`` zero-padded to NC's width; rows
    outside ``real`` keep their colour with qstar 1, and Σ log qstar adds
    up block by block.  conf2 is ``_at_color(nc, cur).sum(1)``."""
    from mcmc_colorer_tpu_torch.models.mcmc import _at_color, _propose

    _check(nc, cur, taboo, unif, real, p_eff, params)
    c, rows, n_col_pad = nc.shape
    dev = nc.device
    star = torch.empty_like(cur)
    new_taboo = torch.empty_like(taboo)
    logq = torch.zeros((c,), dtype=torch.float32, device=dev)
    for k in range(c):
        p_eff_pad = None
        if p_eff is not None:
            p_eff_pad = torch.zeros((n_col_pad,), dtype=torch.float32, device=dev)
            p_eff_pad[:params.n_colors] = p_eff[k]
        for s in range(0, rows, block):
            e = min(s + block, rows)
            cur_b, real_b = cur[k, s:e], real[s:e]
            chosen, qstar, new_taboo[k, s:e] = _propose(
                cur_b, nc[k, s:e] > 0, taboo[k, s:e], unif[k, s:e], params, p_eff_pad, eps
            )
            star[k, s:e] = torch.where(real_b, chosen, cur_b)
            qstar = torch.where(real_b, qstar, 1.0)
            logq[k] += torch.log(qstar.clamp(min=1e-30)).sum()
    return star, new_taboo, logq, _at_color(nc, cur).sum(1)
