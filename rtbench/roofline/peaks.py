"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit): FP32 outside the tensor cores, and HBM3 bandwidth."""

from __future__ import annotations

PEAK_FP32 = 67e12          # FLOP/s
PEAK_BYTES = 3.35e12       # bytes/s


def bound_s(n_bytes: float, n_ops: float) -> tuple:
    """(seconds, "bytes" | "operations"): the least time for ``n_bytes``
    moved and ``n_ops`` FP32 operations, the larger of the two."""
    tb, to = n_bytes / PEAK_BYTES, n_ops / PEAK_FP32
    return max(tb, to), ("bytes" if tb >= to else "operations")
