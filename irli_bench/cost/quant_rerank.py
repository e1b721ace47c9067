"""The coarse rerank on int8 codes a launch (kernels/quant_rerank)."""
from __future__ import annotations


def cost(Q: int, C: int, D: int, k: int, L: int, *, n_blocks: int = 1,
         code_bytes: int = 1, valid: int | None = None,
         rows: int | None = None) -> dict:
    """2·D operations a valid slot (dequantize and score), the queries and
    the [Q, C] ids and counts read once, each distinct valid row's codes and
    scales once, the [Q, k'] ids and scores written once. ``valid`` (slots
    whose count reaches tau) and ``rows`` (distinct ids among them) depend
    on the data: by default every slot is valid and distinct."""
    valid = Q * C if valid is None else valid
    rows = min(valid, L) if rows is None else rows
    scales = n_blocks * 4 if code_bytes == 1 else 0
    return {"flops": valid * 2 * D,
            "bytes": Q * D * 4 + Q * C * 8 + rows * (D * code_bytes + scales)
            + Q * min(k, C) * 8}
