"""Kernel K4 (``csrc/propose_nc.cu``): the proposal over NC, the
neighbour count of each vertex in each colour.  Frozen copy of
``chip_smoke.py:_k4_bytes`` (``:3602-3609``):

- bytes, each once: NC's first n_colors columns of every row (rounded up
  to 4 colours, the kernel's 16-byte copies; the padding past them is
  not read), the [C, rows] vectors in (cur, taboo, unif) and out (star,
  new_taboo, qstar), ``real`` (a byte a row), p_eff and conf2 (8 a
  chain);
- operations: none counted.  A colour of a row costs the kernel a few
  float32 operations (occupancy, q, a CDF step) against the 4 bytes of
  its count, and 4 bytes take 1.2e-12 s at the memory rate where ten
  float32 operations take 1.5e-13 s at theirs: the bytes bound it.
"""

from colorbench.peaks import FP32_OPS_PER_S

KERNEL = "propose_nc_kernel"
WRAPS = ("mcmc_colorer_tpu_torch.ops.propose_nc", "propose_nc_cuda")
OPS_PER_S = FP32_OPS_PER_S


def work(args, kwargs, memo):
    nc, _cur, _taboo, _unif, _real, p_eff, _eps, params = args[:8]
    c, rows, _ = nc.shape
    palette = -(-params.n_colors // 4) * 4
    p_eff_bytes = 0 if p_eff is None else p_eff.numel() * p_eff.element_size()
    return 4 * c * rows * palette + 6 * 4 * c * rows + rows + p_eff_bytes + 8 * c, 0
