"""FrequentOnes a launch (kernels/freq_topc)."""
from __future__ import annotations


def cost(Q: int, C0: int, C: int) -> dict:
    """No arithmetic worth a peak (the radix passes' ranks and scatters);
    the [Q, C0] int32 candidates read once and the [Q, C] ids and counts
    written once."""
    return {"flops": 0, "bytes": Q * C0 * 4 + Q * C * 8}
