"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): the ceilings of every roofline and mfu
share. The configurations state IEEE fp32 scoring, so the FMA peak outside
the tensor cores is the ceiling for operations."""
from __future__ import annotations

#: fp32 operations a second outside the tensor cores
FP32_FLOPS = 67e12
#: HBM3 bytes a second
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for this work: the larger of the
    operations at the fp32 peak and the bytes at the memory rate."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
