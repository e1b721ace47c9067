"""Plain PyTorch version of the masked distance + top-k kernel.

Same contract as the reference's ``distance_topk_ref`` (its oracle,
``repro/kernels/distance_topk/ref.py``): the metric is
``core/query.pairwise_sim`` (the kernel's "dot" is its "angular"), entries
where the mask is 0 score -inf, and the top-k is ``core/topk.topk_stable``
(``jax.lax.top_k``'s order). Builds the whole [Q, L] similarity table.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import topk_stable


def distance_topk_ref(queries, base, mask, *, k: int, metric: str = "dot"):
    """queries [Q, d], base [L, d], mask [Q, L] (or broadcastable to it;
    entries > 0 keep, as the reference's) -> (vals [Q, k] f32, ids [Q, k]
    int32). (``core.query`` imports this module: its metric comes in late.)
    """
    from repro_torch.core.query import pairwise_sim
    sim = pairwise_sim(queries.to(torch.float32), base.to(torch.float32),
                       "l2" if metric == "l2" else "angular")
    sim = torch.where(mask > 0, sim,
                      torch.full((), -torch.inf, device=sim.device))
    vals, idx = topk_stable(sim, k)
    return vals, idx.to(torch.int32)
