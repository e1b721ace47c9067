"""The fused query kernel's work a launch (kernels/mega_query)."""
from __future__ import annotations

from irli_bench.cost.search_step import refine_depth


def cost(R: int, Q: int, d: int, H: int, B: int, ML: int, L: int, *,
         m: int, topC: int, refine_k: int, k: int, block: int = 32,
         row_bytes: int | None = None, valid: int | None = None,
         refine: int | None = None, buckets: int | None = None,
         code_rows: int | None = None,
         refine_rows: int | None = None) -> dict:
    """Both scorer GEMMs (2·R·Q·(d·H + H·B)) and 2·d operations a valid
    coarse slot and a refined survivor; the scorer and the queries read
    once, each probed bucket's member row once, each distinct code row and
    refine row once (``row_bytes`` a row: int8 codes and their scales by
    default), the ids, scores and counts written once. What the data
    decides defaults to the shapes' count: every one of the Q·C coarse
    slots valid and distinct, every probe a distinct bucket, Q·k' refined
    rows."""
    C = min(topC, R * m * ML)
    kp = min(refine_depth(k, topC, refine_k), C)
    valid = Q * C if valid is None else valid
    refine = Q * kp if refine is None else refine
    buckets = min(R * Q * m, R * B) if buckets is None else buckets
    code_rows = min(valid, L) if code_rows is None else code_rows
    refine_rows = min(refine, L) if refine_rows is None else refine_rows
    row_bytes = d + d // block * 4 if row_bytes is None else row_bytes
    return {"flops": 2 * R * Q * (d * H + H * B) + (valid + refine) * 2 * d,
            "bytes": (R * d * H + R * H + R * H * B + R * B + Q * d) * 4
            + buckets * ML * 4 + (code_rows + refine_rows) * row_bytes
            + Q * (2 * k + 1) * 4}
