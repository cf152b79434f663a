"""Kernel K1 (``csrc/packed_nc.cu``): NC = A . onehot(colours) over the
bit-packed adjacency.  Frozen copy of ``chip_smoke.py``'s count
(``:310``, ``:2050``, ``_k1_adds`` at ``:2057-2065``):

- bytes: A and the colour vector read once, NC written once
  (chains x rows x n_col_pad int32);
- operations: an add for each set bit of A in a column whose colour lies
  in [0, n_col_pad), for each chain, at the int32 rate.  A is an
  adjacency, so column j holds as many set bits as row j: the adds are
  the row degrees summed over the in-range columns.
"""

import torch

from colorbench.peaks import INT32_OPS_PER_S

KERNEL = "packed_nc_kernel"
WRAPS = ("mcmc_colorer_tpu_torch.ops.packed_nc", "packed_nc_cuda")
OPS_PER_S = INT32_OPS_PER_S
_M32 = 0xFFFFFFFF


def row_degrees(packed: torch.Tensor, band: int = 4096) -> torch.Tensor:
    """[rows] int64 set bits a row of int32 words holding uint32 bits."""
    out = []
    for r0 in range(0, packed.shape[0], band):
        x = packed[r0:r0 + band].to(torch.int64) & _M32
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        out.append((((x * 0x01010101) & _M32) >> 24).sum(1))
    return torch.cat(out)


def work(args, kwargs, memo):
    packed, colors, n_col_pad = args[:3]
    rows = packed.shape[0]
    chains = colors.shape[0] if colors.dim() == 2 else 1
    deg = memo.get(packed, "row_degrees", lambda: row_degrees(packed))
    k = min(colors.shape[-1], rows)
    c = colors.reshape(chains, -1)[:, :k]
    ops = (((c >= 0) & (c < n_col_pad)).to(torch.int64) * deg[:k]).sum()
    n_bytes = (packed.numel() * packed.element_size() + colors.numel() * colors.element_size()
               + chains * rows * n_col_pad * 4)
    return n_bytes, ops
