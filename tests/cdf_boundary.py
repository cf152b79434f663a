"""The CDF-boundary rule by which two samplers of one proposal may differ.

The same q summed in another order (XLA against torch, a kernel against
its plain version) moves the float32 prefix sum by a few ulps, so a
vertex whose uniform lies on a CDF step may pick the neighbouring
colour.  Imports neither JAX nor the JAX package, so tests that run on
the card use it too."""

import numpy as np


def assert_boundary_only(star_t, star_j, unif, cdf_j, n_real):
    """Every vertex where the two samples differ is a CDF-boundary vertex,
    and there are at most 0.1 % of them; returns their indices."""
    mism = np.flatnonzero(np.asarray(star_t) != np.asarray(star_j))
    assert mism.size <= 0.001 * n_real, f"{mism.size} sample mismatches"
    for v in mism:
        k, u = int(star_j[v]), float(unif[v])
        near = [abs(u - float(cdf_j[v, c])) <= 1e-5 * u for c in (k, k - 1) if c >= 0]
        assert any(near), f"vertex {v}: u={u} not on JAX's cdf step at colour {k}"
    return mism
