"""Plain PyTorch version of the fused query kernel: the compact op
sequence, stage by stage, with every stage's plain version (the reference's
``mega_search_ref``). The CPU takes it for ``mode="mega"``; on the card it is
what the kernel is held against, and nothing on the card's path calls it.
"""
from __future__ import annotations

import torch

from repro_torch.core.network import scorer_logits
from repro_torch.core.query import (gather_members, mask_tombstones,
                                    probe_keep_mask, rerank_gathered)
from repro_torch.core.topk import topk_stable
from repro_torch.kernels.freq_topc.ref import freq_topc_ref
from repro_torch.kernels.quant_rerank.ref import quant_rerank_ref
from repro_torch.store.quantized import QuantizedStore
from repro_torch.store.rerank import refine_stage, resolve_refine_k


def mega_search_ref(params, members, base, queries, delta_members=None,
                    tombstone=None, *, m: int, tau: int, topC: int, k: int,
                    refine_k: int = 0, metric: str = "angular",
                    adaptive_m: bool = False, probe_mass: float = 1.0,
                    chunk: int | None = None):
    """-> (ids [Q, k] int32 with -1 pads, scores [Q, k] f32, n_candidates
    [Q] int32): the compact path. ``base`` is a raw fp32 [L, d] tensor or a
    QuantizedStore; quantized stores run the coarse + refine rerank, whose
    coarse stage dequantizes ``chunk`` candidates a query at a time
    (``quant_rerank_ref``; None: all at once)."""
    store = base if isinstance(base, QuantizedStore) else None
    logits = scorer_logits(params, queries)
    vals, bidx = topk_stable(logits, m)
    keep = (probe_keep_mask(logits, vals, probe_mass)
            if adaptive_m and probe_mass < 1.0 else None)
    cands = gather_members(members, bidx, delta_members, probe_keep=keep)
    if tombstone is not None:
        cands = mask_tombstones(cands, tombstone)
    cid, cnt = freq_topc_ref(cands, C=topC)
    if store is not None and store.dtype != "fp32":
        kp = resolve_refine_k(refine_k, k, topC)
        cids, _ = quant_rerank_ref(queries, store.codes, store.scales, cid,
                                   cnt, tau=tau, k=kp, metric=metric,
                                   chunk=chunk)
        ids, scores = refine_stage(queries, store, cids, k=k, metric=metric)
    else:
        rows = store.codes if store is not None else base
        ids, scores = rerank_gathered(queries, rows, cid, cnt, tau, k,
                                      metric)
    n_cand = ((cid >= 0) & (cnt >= tau)).sum(dim=1, dtype=torch.int32)
    return ids, scores, n_cand
