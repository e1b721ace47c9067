"""Plain PyTorch version of the quantized coarse-rerank kernel.

Contract shared with the reference's ``quant_rerank_ref`` and the CUDA
kernel: per-pair score = q · (codes * repeat(scales, block)) for angular,
-Σ(q - deq)² for l2; invalid slots (id < 0 or count < tau) score -inf and
emit id -1; top-k ties break toward the smaller candidate position.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import topk_stable
from repro_torch.store.quantized import dequant_gathered


def quant_rerank_ref(queries, codes, scales, cand_ids, cand_counts, *,
                     tau: int, k: int, metric: str = "angular"):
    """-> (ids [Q, k] int32 with -1 pads, scores [Q, k] f32, -inf on pads).
    ``scales=None`` means scale-less (bf16) codes. Gathers all C candidate
    rows at once: a [Q, C, D] fp32 intermediate."""
    k = min(k, cand_ids.shape[1])
    block = codes.shape[1] // scales.shape[1] if scales is not None else 0
    deq = dequant_gathered(codes, scales, cand_ids.clamp_min(0).long(),
                           block)                            # [Q, C, D] f32
    q = queries[:, None, :]
    if metric == "l2":
        sim = -((q - deq) ** 2).sum(dim=-1)
    else:
        sim = (q * deq).sum(dim=-1)
    valid = (cand_ids >= 0) & (cand_counts >= tau)
    sim = torch.where(valid, sim, torch.full_like(sim, -torch.inf))
    vals, pos = topk_stable(sim, k)
    ids = torch.gather(cand_ids, 1, pos)
    ids = torch.where(torch.isfinite(vals), ids, torch.full_like(ids, -1))
    return ids.to(torch.int32), vals


def near_tie_rows(scores, kp: int, rtol: float = 1e-5):
    """The rows whose kernel top-k' SET may differ from the plain one:
    ``scores`` [Q, k'+1] is the plain top-(k'+1), and a row is flagged when
    its k'-th and (k'+1)-th scores are finite, differ, and lie within
    ``rtol`` (relative to max(|score|, 1)) — a sum taken in another order
    may swap them across the cut. Equal scores (the same row twice) are
    not flagged: the kernel computes them alike and breaks the tie by
    position, as the plain version does. With k' = C there is no cut."""
    if scores.shape[1] <= kp:
        return torch.zeros(scores.shape[0], dtype=torch.bool,
                           device=scores.device)
    a, b = scores[:, kp - 1], scores[:, kp]
    gap = a - b
    return (torch.isfinite(b) & (gap > 0)
            & (gap <= rtol * b.abs().clamp_min(1.0)))


def same_topk(ids, ref_ids, scores, ref_scores, ref_wide, rtol=1e-5):
    """The kernel-vs-plain rule for a coarse top-k': scores agree position
    by position to ``rtol`` (absolute and relative); outside the
    :func:`near_tie_rows` each row holds the same ids as the plain one, in
    an order that may differ only among scores within that tolerance (the
    fp32 sums run in another order). Returns the number of flagged rows;
    raises AssertionError on a breach."""
    torch.testing.assert_close(scores, ref_scores, rtol=rtol, atol=rtol)
    tie = near_tie_rows(ref_wide, ids.shape[1], rtol)
    got = torch.sort(ids[~tie], dim=1).values
    want = torch.sort(ref_ids[~tie], dim=1).values
    if not torch.equal(got, want):
        bad = int((got != want).any(dim=1).sum())
        raise AssertionError(f"{bad} rows hold other ids than the plain "
                             f"top-k' outside the near-tie rows")
    return int(tie.sum())
