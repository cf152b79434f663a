"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit), the yardstick of every roofline share.

Frozen copy of ``chip_smoke.py:199-205``: the device memory rate, the
float32 rate outside the tensor cores, and int32 adds and logic ops at
half the float32 rate (64 of an SM's 128 lanes a clock).
"""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = FP32_OPS_PER_S / 2


def bound_s(n_bytes: float, ops: float, ops_per_s: float) -> float:
    """The least time the chip could take: the larger of the bytes over
    the memory rate and the operations over their peak rate
    (``chip_smoke.py:234-239``)."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / ops_per_s)
