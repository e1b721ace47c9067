"""Two-stage rerank over a QuantizedStore: coarse-on-codes, exact-on-k'.
Port of ``repro/store/rerank.py``.

Stage 1 (coarse) scores the compact candidate list [Q, C] on gathered
QUANTIZED code rows — dispatched through kernels/quant_rerank/ops (the CUDA
kernel on the card, the plain version on the CPU) — and keeps the k' best
per query. Stage 2 (refine) gathers only those k' rows at fp32 (the exact
tier, or on-the-fly dequant) and re-scores them with core/query.gathered_sim,
so the final top-k ordering is exact over the surviving set.
"""
from __future__ import annotations

import torch

from repro_torch.core.query import gathered_sim
from repro_torch.core.topk import topk_stable
from repro_torch.store.quantized import (QuantizedStore, check_scales,
                                         refine_rows)


def resolve_refine_k(refine_k: int, k: int, topC: int) -> int:
    """The k' knob: 0 means auto (4k, at least 32); always at least k and
    never more than the candidate budget."""
    kp = refine_k if refine_k > 0 else max(4 * k, 32)
    return max(k, min(kp, topC))


def coarse_stage(queries, store: QuantizedStore, cand_ids, cand_counts, *,
                 tau: int, k: int, refine_k: int = 0,
                 metric: str = "angular"):
    """Stage 1 alone: coarse top-k' survivor ids [Q, k'] (-1 pads)."""
    from repro_torch.kernels.quant_rerank.ops import quant_coarse_topk
    check_scales(store)
    kp = resolve_refine_k(refine_k, k, cand_ids.shape[1])
    cids, _ = quant_coarse_topk(queries, store.codes, store.scales,
                                cand_ids, cand_counts, tau=tau, k=kp,
                                metric=metric)
    return cids


def refine_stage(queries, store: QuantizedStore, cids, *, k: int,
                 metric: str = "angular"):
    """Stage 2 alone: exact fp32 re-score of the k' coarse survivors ->
    (ids [Q, k] int32, scores [Q, k] f32). The final scores always come
    from this one gathered_sim call, whatever coarse backend selected the
    k' set: the kernel's fp32 sums run in another order than the plain
    version's."""
    vecs = refine_rows(store, cids.clamp_min(0).long())        # [Q, k', D]
    sim = torch.where(cids >= 0, gathered_sim(queries, vecs, metric),
                      torch.full(cids.shape, -torch.inf, device=cids.device))
    scores, pos = topk_stable(sim, min(k, cids.shape[1]))
    ids = torch.gather(cids, 1, pos)
    ids = torch.where(torch.isfinite(scores), ids, torch.full_like(ids, -1))
    if scores.shape[1] < k:             # k > topC: pad the unservable tail
        pad = k - scores.shape[1]
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        scores = torch.nn.functional.pad(scores, (0, pad), value=-torch.inf)
    return ids.to(torch.int32), scores


def rerank_two_stage(queries, store: QuantizedStore, cand_ids, cand_counts,
                     *, tau: int, k: int, refine_k: int = 0,
                     metric: str = "angular"):
    """queries [Q, d], cand_ids/cand_counts [Q, C] (the frequency_topC
    output) -> (ids [Q, k] with -1 where no candidate survived, scores
    [Q, k] exact similarities, -inf on pads)."""
    cids = coarse_stage(queries, store, cand_ids, cand_counts, tau=tau,
                        k=k, refine_k=refine_k, metric=metric)
    return refine_stage(queries, store, cids, k=k, metric=metric)
