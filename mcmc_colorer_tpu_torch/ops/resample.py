"""Kernel K2 — the resample sweep over neighbour ids — and its plain
version.

Replaces ``mcmc_colorer_tpu/ops/pallas_resample.py:pallas_sweep``
together with the neighbour gather in front of it.  Per row of neighbour
ids ``neighbors`` (own vertex id ``row0`` + the row, or ``self_ids[row]``
when the rows are a frontier's: ``models/mcmc_active.py``) it looks up the
neighbours' colours in ``colors`` (an id outside ``[0, len(colors))``,
such as the ELL padding id ``n_pad``, counts nowhere), counts the
conflicts of the current colour (neighbours with a larger id only),
builds the occupancy, the proposal q of ``params.proposal``, samples the
inverse CDF at ``unif`` and applies the taboo.  It returns ``(star,
qstar, new_taboo, conflicts)``, conflicts as a 0-dim tensor on the
device.

``resample_sweep`` dispatches on where ``neighbors`` lies:

- CPU tensors go to ``resample_sweep_plain``: the gather
  ``gathered_colors``, then ``resample_sweep_reference``, the port of the
  XLA sweep's block function (``models/mcmc.py:_propose``) plus the
  conflict count, over the gathered band;
- CUDA tensors go to the hand-written kernel ``csrc/resample.cu`` (built
  with nvcc for sm_90a at first use), which looks the colours up itself,
  or raise.  There is no fallback from the card to the plain version.

The kernel runs in one of two regimes, chosen by shape alone
(``sweep_shape``): it stages the colour vector in shared memory when it
fits there, else it reads it from L2.

Occupancy and conflicts are integer work and agree exactly.  The kernel
adds the float32 reminder and the CDF prefix in another order than
torch, so ``star`` may differ from the plain version's where the uniform
lies on a CDF step (``tests/test_torch_resample.py`` states the rule).
``launches`` counts the kernel's launches.

A chain axis: with ``colors`` [C, n] (an ensemble's chains over one
shared ELL, what JAX's ``vmap`` of the sweep computes), ``cur``, ``taboo``
and ``unif`` are [C, rows] and ``p_eff`` [C, n_colors] (each chain's
balance-dynamic distribution comes from its own histogram); ``neighbors``,
``self_ids`` and ``eps`` are shared.  The outputs are then [C, rows] and
the conflicts [C], one launch for all chains; ``sweep_shape`` still
chooses the regime from one chain's vector.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import torch

from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
from mcmc_colorer_tpu_torch.ops.dense_adj import SWEEP_BLOCK_BYTES
from mcmc_colorer_tpu_torch.ops.firstfit import _kernel_shape, palette_ok
from mcmc_colorer_tpu_torch.ops.neighbor import (
    neighbor_colors,
    neighbor_colors_chains,
    occupancy_matrix,
)
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
# the staged regime keeps colours as uint16, 0xFFFF marking one outside
# [0, 65535), so it serves palettes below 65535 colours
STAGED_COLORS_MAX = 0xFFFF
STAGED_MAX_WARPS = 32  # 1024 threads, the most a block may have
# fewer warps an SM keep too few id loads in flight to stream at memory
# speed; the L2 regime then serves the shape
STAGED_MIN_WARPS = 8

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
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 2
            + [ctypes.c_float] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        err = built.lib.resample_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _built = built
    return _built


@dataclass(frozen=True)
class SweepShape:
    """How K2 runs: staged or L2, warps (rows in flight) a block, copies of
    a row's occupancy mask, and the block's shared memory in bytes."""

    staged: bool
    warps: int
    copies: int
    smem_bytes: int


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def sweep_shape(n_ids: int, n_colors: int, l2: bool = False) -> SweepShape:
    """K2's regime for a colour vector of ``n_ids`` and a palette of
    ``n_colors`` (``csrc/resample.cu`` lays shared memory out the same
    way: masks, then p_eff, then the uint16 colours, each 16-byte
    aligned).  Staged when the palette is below 65535 colours and, beside
    p_eff and the staged colours, at least ``STAGED_MIN_WARPS`` rows'
    masks fit (four copies each, fewer if that is what fits); else L2,
    K3's shape (``ops/firstfit.py:_kernel_shape``).  ``l2`` forces L2."""
    n_words = (n_colors + 31) // 32
    if not l2 and n_colors < STAGED_COLORS_MAX:
        stage = _round16(4 * n_colors) + _round16(2 * n_ids)
        left = (SMEM_BLOCK_BYTES - stage) // 16 * 16
        for copies in (4, 2, 1):
            warps = min(STAGED_MAX_WARPS, max(left, 0) // (n_words * copies * 4))
            if warps >= STAGED_MIN_WARPS:
                return SweepShape(True, warps, copies,
                                  _round16(warps * n_words * copies * 4) + stage)
    rows, copies = _kernel_shape(n_colors)
    return SweepShape(False, rows, copies, _round16(rows * n_words * copies * 4))


def _eps_tensor(eps, device) -> torch.Tensor:
    if isinstance(eps, torch.Tensor):
        return eps.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), eps, dtype=torch.float32, device=device)  # no host copy


def _p_eff_or_zeros(p_eff, n_colors: int, device, chains: int = 0) -> torch.Tensor:
    if p_eff is None:
        shape = (chains, n_colors) if chains else (n_colors,)
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return p_eff


def _check_rows(rows: int, device, vectors, p_eff, params, chains: int = 0):
    """``vectors``: (name, tensor, dtype) of the per-row inputs, [rows],
    or [chains, rows] where ``chains`` is given (p_eff then [chains,
    n_colors])."""
    lead = (chains,) if chains else ()
    for name, t, dt in vectors:
        if t.dtype != dt or tuple(t.shape) != (*lead, rows):
            raise TypeError(f"{name} must be {[*lead, rows]} {dt}, got {t.dtype} "
                            f"{tuple(t.shape)}")
    if p_eff.dtype != torch.float32 or tuple(p_eff.shape) != (*lead, params.n_colors):
        raise TypeError(f"p_eff must be {[*lead, params.n_colors]} float32, got "
                        f"{p_eff.dtype} {tuple(p_eff.shape)}")
    for t in (p_eff, *(v[1] for v in vectors)):
        if t.device != device:
            raise ValueError(f"the rows lie on {device} but an argument on {t.device}")


def _vectors(cur, taboo, unif):
    return [("cur", cur, torch.int32), ("taboo", taboo, torch.int32),
            ("unif", unif, torch.float32)]


def _check(neighbors, colors, cur, taboo, row0, unif, p_eff, params, self_ids=None):
    if neighbors.dtype != torch.int32 or neighbors.dim() != 2:
        raise TypeError(f"neighbors must be 2-D int32, got {neighbors.dtype} "
                        f"{tuple(neighbors.shape)}")
    if colors.dtype != torch.int32 or colors.dim() not in (1, 2):
        raise TypeError(f"colors must be [n] or [C, n] int32, got {colors.dtype} "
                        f"{tuple(colors.shape)}")
    if colors.device != neighbors.device:
        raise ValueError(f"neighbors on {neighbors.device} but colors on {colors.device}")
    rows = neighbors.shape[0]
    if not 0 <= row0 <= 2**31 - 1 - rows:
        raise ValueError(f"row0={row0}: own ids must be int32")
    chains = _chains(colors)
    if chains and cur.dim() != 2:
        raise TypeError(f"colors {tuple(colors.shape)} has a chain axis, so cur, taboo and "
                        f"unif must be [C, rows]; got cur {tuple(cur.shape)}")
    _check_rows(rows, neighbors.device, _vectors(cur, taboo, unif), p_eff, params, chains)
    if self_ids is not None:
        _check_rows(rows, neighbors.device, [("self_ids", self_ids, torch.int32)],
                    p_eff[0] if chains else p_eff, params)


def _chains(colors) -> int:
    """The chain count of a [C, n] colour tensor; 0 for one chain's [n]."""
    return colors.shape[0] if colors.dim() == 2 else 0


def resample_sweep(neighbors, colors, cur, taboo, row0: int, unif, p_eff, eps,
                   params: MCMCParams, self_ids=None):
    """One sweep over the rows of ``neighbors``, whose own ids are ``row0``
    on, or ``self_ids`` ([rows] int32) where given: (star, qstar,
    new_taboo, conflicts).  ``p_eff`` is [n_colors] float32 (None for
    STANDARD).  With a chain axis (``colors`` [C, n]) every per-chain
    input and output gains a leading C and the conflicts are [C]."""
    if neighbors.device.type == "cpu":
        return resample_sweep_plain(
            neighbors, colors, cur, taboo, row0, unif, p_eff, eps, params, self_ids
        )
    if neighbors.device.type != "cuda":
        raise ValueError(f"no K2 for device {neighbors.device}")
    return resample_sweep_cuda(
        neighbors, colors, cur, taboo, row0, unif, p_eff, eps, params, self_ids
    )


def resample_sweep_cuda(neighbors, colors, cur, taboo, row0: int, unif, p_eff, eps,
                        params: MCMCParams, self_ids=None, *, _l2: bool = False):
    """Launch K2 on the current stream of the tensors' card.  ``_l2``
    forces the L2 regime, so that a check can hold both regimes on the
    same inputs."""
    global launches
    n_colors = params.n_colors
    chains = _chains(colors)
    p_eff = _p_eff_or_zeros(p_eff, n_colors, neighbors.device, chains)
    _check(neighbors, colors, cur, taboo, row0, unif, p_eff, params, self_ids)
    if neighbors.device.type != "cuda":
        raise ValueError(f"K2 needs CUDA tensors, got {neighbors.device}")
    args = (neighbors, colors, cur, taboo, unif, p_eff)
    if self_ids is not None:
        args += (self_ids,)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("K2 needs contiguous inputs")
    if not palette_ok(n_colors):
        raise ValueError(
            f"n_colors={n_colors}: one row's occupancy bitmask exceeds the "
            f"{SMEM_BLOCK_BYTES} bytes of shared memory a block may use"
        )
    rows, d_pad = neighbors.shape
    if d_pad % 4 == 0 and neighbors.data_ptr() % 16:
        raise ValueError("K2 reads rows of d_pad % 4 == 0 as 16-byte vectors: align neighbors")
    dev = neighbors.device
    n_ids = colors.shape[-1]
    shape = sweep_shape(n_ids, n_colors, l2=_l2)
    blocks = -(-rows // shape.warps)
    if shape.staged:
        # persistent: about one block an SM, rows in a grid-stride loop;
        # a chain gets SMs / C blocks, each staging that chain's vector
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks = min(blocks, max(1, sms // max(chains, 1)))
    eps_t = _eps_tensor(eps, dev)
    lead = (chains,) if chains else ()
    star = torch.empty((*lead, rows), dtype=torch.int32, device=dev)
    qstar = torch.empty((*lead, rows), dtype=torch.float32, device=dev)
    new_taboo = torch.empty((*lead, rows), dtype=torch.int32, device=dev)
    conf = torch.empty((*lead, rows), dtype=torch.int32, device=dev)
    if rows == 0 or (chains == 0 and colors.dim() == 2):
        return star, qstar, new_taboo, conf.sum(-1)
    lib = load_kernel().lib
    with torch.cuda.device(dev):
        rc = lib.resample_launch(
            neighbors.data_ptr(), colors.data_ptr(), n_ids,
            cur.data_ptr(), taboo.data_ptr(), unif.data_ptr(), p_eff.data_ptr(),
            eps_t.data_ptr(), star.data_ptr(), qstar.data_ptr(), new_taboo.data_ptr(),
            conf.data_ptr(), rows, d_pad, row0,
            None if self_ids is None else self_ids.data_ptr(), n_colors,
            _KIND_CODE[params.proposal],
            float(params.lambda_), int(params.lambda_ == 0.0), params.taboo_iterations,
            int(shape.staged), shape.warps, shape.copies, blocks, max(chains, 1),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"K2 launch failed: {lib.resample_error_string(rc).decode()} ({rc})"
        )
    launches += 1
    return star, qstar, new_taboo, conf.sum(-1)


def resample_sweep_plain(neighbors, colors, cur, taboo, row0: int, unif, p_eff, eps,
                         params: MCMCParams, self_ids=None):
    """Plain version of K2: the gather ``gathered_colors``, then
    ``resample_sweep_reference`` on the gathered band with own ids
    ``self_ids``, or ``row0`` on; with a chain axis, on the chains' bands
    stacked row-wise (each row block reads its chain's p_eff)."""
    chains = _chains(colors)
    p_eff = _p_eff_or_zeros(p_eff, params.n_colors, neighbors.device, chains)
    _check(neighbors, colors, cur, taboo, row0, unif, p_eff, params, self_ids)
    rows = neighbors.shape[0]
    if self_ids is None:
        self_ids = torch.arange(row0, row0 + rows, dtype=torch.int32, device=neighbors.device)
    if not chains:
        return resample_sweep_reference(gathered_colors(neighbors, colors), neighbors, cur,
                                        taboo, self_ids, unif, p_eff, eps, params)
    nc = gathered_colors(neighbors, colors).reshape(chains * rows, -1)
    out = resample_sweep_reference(
        nc, neighbors.repeat(chains, 1), cur.reshape(-1), taboo.reshape(-1),
        self_ids.repeat(chains), unif.reshape(-1), p_eff, eps, params, chains=chains,
    )
    return (*(x.reshape(chains, rows) for x in out[:3]), out[3])


def gathered_colors(neighbors, colors) -> torch.Tensor:
    """[rows, d_pad] neighbour colours as K2 sees them: ``colors[id]``, and
    -1 for an id outside ``[0, len(colors))``; [C, rows, d_pad] for
    colours [C, n]."""
    n_ids = colors.shape[-1]
    ids = torch.where((neighbors >= 0) & (neighbors < n_ids), neighbors, n_ids)
    if colors.dim() == 2:
        return neighbor_colors_chains(ids, colors)
    return neighbor_colors(ids, colors)


def resample_sweep_reference(nc, neighbors, cur, taboo, self_ids, unif, p_eff,
                             eps, params: MCMCParams, block: int | None = None,
                             chains: int = 0):
    """K2 over a gathered band ``nc`` (-1 = padding) and its ids: per row
    block, ``occupancy_matrix`` and the proposal, sample and taboo keep of
    ``models/mcmc.py:_propose`` (the XLA sweep's block function), plus the
    conflict count.  Blocks bound the [rows, n_colors] float32
    temporaries.  ``chains`` > 0: the rows are that many chains' bands
    stacked, ``p_eff`` is [chains, n_colors] (row r reads its chain's, r //
    (rows / chains)) and the conflicts are counted a chain ([chains])."""
    from mcmc_colorer_tpu_torch.models.mcmc import _propose

    n_colors = params.n_colors
    dev = nc.device
    p_eff = _p_eff_or_zeros(p_eff, n_colors, dev, chains)
    if nc.dtype != torch.int32 or nc.dim() != 2:
        raise TypeError(f"nc must be 2-D int32, got {nc.dtype} {tuple(nc.shape)}")
    if neighbors.dtype != torch.int32 or neighbors.shape != nc.shape:
        raise TypeError(f"neighbors must be int32 {tuple(nc.shape)}, got "
                        f"{neighbors.dtype} {tuple(neighbors.shape)}")
    rows = nc.shape[0]
    if chains and rows % chains:
        raise ValueError(f"{rows} rows do not split into {chains} chains")
    _check_rows(rows, dev, _vectors(cur, taboo, unif) + [("self_ids", self_ids, torch.int32)],
                p_eff[0] if chains else p_eff, params)
    if chains and tuple(p_eff.shape) != (chains, n_colors):
        raise TypeError(f"p_eff must be [{chains}, {n_colors}], got {tuple(p_eff.shape)}")
    eps_t = _eps_tensor(eps, dev)
    block = block or max(128, SWEEP_BLOCK_BYTES // (4 * n_colors))
    star = torch.empty((rows,), dtype=torch.int32, device=dev)
    qstar = torch.empty((rows,), dtype=torch.float32, device=dev)
    new_taboo = torch.empty((rows,), dtype=torch.int32, device=dev)
    conf = torch.zeros((), dtype=torch.int64, device=dev)
    conf_rows = torch.zeros((rows,), dtype=torch.int64, device=dev) if chains else None
    for s in range(0, rows, block):
        e = min(s + block, rows)
        nc_b, cur_b = nc[s:e], cur[s:e]
        hits = (nc_b == cur_b[:, None]) & (neighbors[s:e] > self_ids[s:e, None])
        pe = p_eff
        if chains:
            conf_rows[s:e] = hits.sum(1)
            pe = p_eff[torch.arange(s, e, device=dev) // (rows // chains)]
        else:
            conf += hits.sum()
        star[s:e], qstar[s:e], new_taboo[s:e] = _propose(
            cur_b, occupancy_matrix(nc_b, n_colors), taboo[s:e], unif[s:e], params,
            pe, eps_t,
        )
    if chains:
        conf = conf_rows.reshape(chains, -1).sum(1)
    return star, qstar, new_taboo, conf
