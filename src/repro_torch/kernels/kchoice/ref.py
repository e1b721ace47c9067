"""Plain PyTorch version of the exact power-of-K re-assignment kernel.

The reference's ``kchoice_exact`` (``repro/core/repartition.py``) is a
``lax.scan`` over the labels in insertion order: each label goes to the
FIRST of its K candidate buckets that holds the least load, and that
bucket's float32 load grows by the label's weight. This version walks the
same sequence, one step for all reps at once, on the CPU.
"""
from __future__ import annotations

import torch


def kchoice_ref(topk_idx, order, load0=None, weights=None, *, B: int):
    """topk_idx [G, L, K] int (descending affinity per label), order [G, L]
    (the insertion order, a permutation of 0..L-1 per rep), load0 [G, B] f32
    or None (zeros), weights [L] f32 or None (ones) -> assign [G, L] int32,
    on topk_idx's device. Runs on host copies: the walk is sequential."""
    dev = topk_idx.device
    G, L, K = topk_idx.shape
    t = topk_idx.detach().cpu().long()
    o = order.detach().cpu().long()
    load = (torch.zeros((G, B), dtype=torch.float32) if load0 is None
            else load0.detach().cpu().float().clone().expand(G, B).clone())
    g = torch.arange(G)
    # [L, G, K]: step s holds every rep's s-th label's candidates
    seq = t[g[:, None], o].transpose(0, 1).contiguous()
    inc = (torch.ones((L, G), dtype=torch.float32) if weights is None
           else weights.detach().cpu().float()[o].T.contiguous())
    placed = torch.empty((L, G), dtype=torch.int64)
    for s in range(L):
        cand = seq[s]                                        # [G, K]
        # lexicographic (load, choice-rank): argmin takes the FIRST slot
        # at the minimum load
        b = cand[g, load.gather(1, cand).argmin(dim=1)]
        placed[s] = b
        load[g, b] += inc[s]
    out = torch.empty((G, L), dtype=torch.int64).scatter_(1, o, placed.T)
    return out.to(torch.int32).to(dev)
