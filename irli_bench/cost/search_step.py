"""The whole search step's operations: what the algorithm computes for a
batch, whichever kernels run it (the mfu's numerator)."""
from __future__ import annotations

from irli_bench.reference.search import refine_depth


def flops(cfg: dict, Q: int, *, m: int, valid: int, refined: int) -> int:
    """Q queries: the scorer's hidden layer (2·R·Q·d·H) and output GEMM
    (2·R·Q·H·B), 2·D operations a valid coarse slot (``valid``, summed over
    the queries: their n_candidates) and a refined survivor (``refined``).
    The top-m, FrequentOnes and the top-k' are comparisons, not counted."""
    R, d, H, B = cfg["n_reps"], cfg["d"], cfg["d_hidden"], cfg["n_buckets"]
    del m                                  # the GEMMs score every bucket
    return 2 * R * Q * (d * H + H * B) + 2 * d * (valid + refined)


def refined(n_candidates, k: int, topC: int, refine_k: int = 0) -> int:
    """Refined survivors of queries with these n_candidates: min(k', n)."""
    kp = refine_depth(k, topC, refine_k)
    return int(sum(min(kp, int(n)) for n in n_candidates))
