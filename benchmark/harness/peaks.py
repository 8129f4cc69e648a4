"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit) and the least time of a piece of work.

Copied from ``chip_smoke.py`` (``H100``, ``bound_ms``): the float32 rate
outside the tensor cores and the HBM rate. The card's power limit is
reported beside every reading (``nvidia-smi``).
"""
from __future__ import annotations

F32_FLOPS = 67e12  # float32 operations a second, without tensor cores
HBM_BYTES = 3.35e12  # bytes a second


def least_s(ops: float, nbytes: float) -> float:
    """The larger of the operation time and the byte time at the peaks."""
    return max(ops / F32_FLOPS, nbytes / HBM_BYTES)
