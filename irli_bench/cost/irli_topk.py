"""The scorer's output GEMM and top-m a launch (kernels/irli_topk)."""
from __future__ import annotations


def cost(G: int, Q: int, H: int, B: int, m: int, *, itemsize: int = 4,
         lse: bool = False) -> dict:
    """The output GEMM's 2·G·Q·H·B operations; h [G, Q, H], w2 [G, H, B]
    and b2 [G, B] read once, the top-m values and ids (and the
    log-sum-exp) written once."""
    return {"flops": 2 * G * Q * H * B,
            "bytes": (G * Q * H + G * H * B + G * B) * itemsize
            + G * Q * m * 8 + (G * Q * 4 if lse else 0)}
