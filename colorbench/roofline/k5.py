"""Kernel K5 (``csrc/hash_ell.cu``): the hash graph's ELL rows built on
the card from its definition (``ops/hash_ell.py``), in set-up.  Its work
is the least that defines the graph, whatever implements it:

- operations: the n(n - 1) / 2 unordered pairs, 8 int32 operations each:
  the part of mix32 and the compare that depends on both ends (xor,
  multiply, shift, xor, multiply, shift, xor, compare; the first half
  depends on the lower end alone and can be hoisted);
- bytes: the rectangle [n_pad, d_pad] int32 and the degrees [n_pad]
  written once.

The count launch (no ``d_pad``) books the degrees; the fill launch books
the rectangle and every pair's operations, so the sum over a build is the
whole build's least time.  A kernel that tests each pair from both of its
rows, in both passes, does at least four times these operations, and so
reads at most about 25 % here.
"""

from colorbench.peaks import INT32_OPS_PER_S

KERNEL = "hash_ell_kernel"
WRAPS = ("mcmc_colorer_tpu_torch.ops.hash_ell", "hash_ell_cuda")
OPS_PER_S = INT32_OPS_PER_S


def work(args, kwargs, memo):
    degrees, n = args[0], args[1]
    d_pad = args[4] if len(args) > 4 else kwargs.get("d_pad")
    n_pad = degrees.shape[0]
    if d_pad is None:
        return 4 * n_pad, 0
    return 4 * n_pad * d_pad, 8 * (n * (n - 1) // 2)
