"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the
700 W limit) and the least time of a ``gather_rows_cast`` launch.

The bound is a frozen copy of ``chip_smoke._gather_bound``: the distinct
uint8 rows read once, the bfloat16 rows written and the int64 indices, over
the memory rate, or one conversion a byte over the float32 rate, whichever
is longer.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOPS", "BF16_FLOPS", "gather_bound_s"]

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12


def gather_bound_s(feat: int, batch: int, distinct: float) -> tuple[float, str]:
    """``(seconds, what bounds it)`` of one launch that gathers ``batch``
    rows of ``feat`` uint8 bytes, ``distinct`` of them distinct, into
    bfloat16."""
    bytes_s = (distinct * feat + batch * feat * 2 + batch * 8) / HBM_BYTES_PER_S
    ops_s = batch * feat / FP32_FLOPS
    return max(bytes_s, ops_s), "bytes" if bytes_s >= ops_s else "operations"
