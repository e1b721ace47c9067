"""Iterative re-partitioning — the paper's core contribution (§3.2, Alg. 1).
Port of ``repro/core/repartition.py``.

Re-assignment is power-of-K choices: among the top-K affinity buckets of
each label, place it in the least loaded.

  - ``kchoice_exact``: the sequential process of Thm. 2, verbatim. On the
    card it is one launch of the ``kchoice`` kernel for all reps (the
    reference's ``lax.scan``); on the CPU its plain loop.
  - ``kchoice_parallel``: the capacity-bounded parallel approximation (K
    rounds of argsort), plain torch on either device.

Insertion orders: the reference draws them with ``jax.random`` keys, which
a ``torch.Generator`` cannot reproduce. Here they come from the caller's
generator, or are passed in (``order`` / ``orders``), which is how the
tests hand both packages the same permutation.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.network import scorer_probs
from repro_torch.core.topk import topk_stable
from repro_torch.kernels.kchoice.ops import kchoice_assign


# ------------------------------------------------------------- affinities ---
def affinity_ann(params: dict, label_vecs: torch.Tensor,
                 loss_kind: str = "softmax_bce", batch: int = 4096):
    """Def. 2, dense: P[r, l, :] = f_r(label_vec_l) -> [R, L, B]. The tests'
    control for the streamed affinity (fit/affinity.py)."""
    L = label_vecs.shape[0]
    return torch.cat([scorer_probs(params, label_vecs[s:s + batch],
                                   loss_kind)
                      for s in range(0, L, batch)], dim=1)


def affinity_xml(params: dict, x: torch.Tensor, pair_point, pair_label,
                 n_labels: int, loss_kind: str = "softmax_bce"):
    """Def. 1, dense: P[r, l] = Σ f_r(x_i) over the points i that carry
    label l; pair_point / pair_label are the flattened (i, l) incidence
    lists [P] -> [R, L, B]."""
    probs = scorer_probs(params, x, loss_kind)                 # [R, N, B]
    gathered = probs[:, torch.as_tensor(pair_point).long()]    # [R, P, B]
    R, _, B = probs.shape
    out = torch.zeros((R, n_labels, B), dtype=probs.dtype,
                      device=probs.device)
    return out.index_add_(1, torch.as_tensor(pair_label).long().to(
        probs.device), gathered)


# ------------------------------------------------------ exact power-of-K ----
def kchoice_exact(topk_idx: torch.Tensor, B: int, order=None,
                  generator: torch.Generator | None = None, load0=None,
                  weights=None) -> torch.Tensor:
    """Sequential least-loaded-of-top-K insertion (Alg. 1 / Thm. 2).

    topk_idx [L, K] per-label top-K affinity buckets (descending affinity)
    -> assign [L] int32. Labels go in ``order`` ([L], a permutation), else
    in a random order drawn from ``generator``, else in id order. ``load0``
    [B] seeds the float32 bucket loads (default zeros); ``weights`` [L]
    scales each label's load contribution (default 1). Ties go to the
    first slot attaining the minimum load, at any load magnitude."""
    L = topk_idx.shape[0]
    order = insertion_orders(1, L, topk_idx.device, generator,
                             None if order is None else order[None])
    return kchoice_assign(topk_idx[None], order, load0, weights, B=B)[0]


def insertion_orders(R: int, L: int, device, generator=None, orders=None):
    """[R, L] int64 insertion orders: ``orders`` as given, else one
    ``torch.randperm`` per rep from ``generator`` (drawn on the CPU), else
    the identity."""
    if orders is not None:
        return torch.as_tensor(orders).to(device=device, dtype=torch.int64)
    if generator is None:
        return torch.arange(L, device=device).expand(R, L)
    return torch.stack([torch.randperm(L, generator=generator)
                        for _ in range(R)]).to(device)


# -------------------------------------------------- parallel approximation --
def kchoice_parallel(topk_val: torch.Tensor, topk_idx: torch.Tensor, B: int,
                     slack: float = 1.05) -> torch.Tensor:
    """Capacity-bounded parallel K-choices: topk_val, topk_idx [L, K] ->
    assign [L] int32.

    Round t: unplaced labels bid on their t-th choice; each bucket admits
    its highest-affinity bidders up to the remaining capacity
    cap = ceil(slack·L/B). Stragglers then go to the least loaded of their
    top-K given the final loads. Bidders are ranked by a float32 sort of
    ``bucket·4 - sigmoid(affinity)``; the sort is stable, as the
    reference's ``jnp.argsort``, so equal keys keep label order."""
    L, K = topk_idx.shape
    dev = topk_idx.device
    topk_idx = topk_idx.long()
    cap = int(math.ceil(float(np.float32(slack * L / B))))
    assign = torch.full((L,), -1, dtype=torch.int64, device=dev)
    load = torch.zeros((B,), dtype=torch.int64, device=dev)
    pos = torch.arange(L, device=dev)
    for t in range(K):
        unplaced = assign < 0
        bid_bucket = torch.where(unplaced, topk_idx[:, t],
                                 torch.full_like(topk_idx[:, t], B))
        bid_aff = torch.where(unplaced, topk_val[:, t].float(),
                              torch.full_like(topk_val[:, t].float(),
                                              -torch.inf))
        comp = bid_bucket.float() * 4.0 - torch.sigmoid(bid_aff)
        order = torch.argsort(comp, stable=True)
        sb = bid_bucket[order]
        counts = torch.bincount(sb, minlength=B + 1)
        starts = torch.cumsum(counts, 0) - counts
        rank = pos - starts[sb]
        remaining = torch.clamp(cap - load, min=0)
        admitted = (rank < remaining[torch.clamp(sb, max=B - 1)]) & (sb < B)
        assign[order] = torch.where(admitted, sb, assign[order])
        load += torch.bincount(torch.where(admitted, sb,
                                           torch.full_like(sb, B)),
                               minlength=B + 1)[:B]
    cand_loads = load[topk_idx]                                  # [L, K]
    j = (cand_loads == cand_loads.min(dim=1, keepdim=True).values
         ).int().argmax(dim=1)
    least = topk_idx.gather(1, j[:, None])[:, 0]
    return torch.where(assign < 0, least, assign).to(torch.int32)


def repartition_topk(topk_val: torch.Tensor, topk_idx: torch.Tensor, B: int,
                     mode: str = "exact", orders=None,
                     generator: torch.Generator | None = None,
                     slack: float = 1.05) -> torch.Tensor:
    """Re-assign from already-reduced top-K affinities [R, L, K] -> assign
    [R, L] int32. Exact mode runs all R reps in one ``kchoice`` launch on
    the card, each rep in its insertion order (``orders`` [R, L], else drawn
    from ``generator``, else id order)."""
    R, L, _ = topk_idx.shape
    if mode == "exact":
        order = insertion_orders(R, L, topk_idx.device, generator, orders)
        return kchoice_assign(topk_idx, order, B=B)
    if mode != "parallel":
        raise ValueError(f"unknown repartition mode {mode!r}")
    return torch.stack([kchoice_parallel(topk_val[r], topk_idx[r], B, slack)
                        for r in range(R)])


def repartition(affinity: torch.Tensor, K: int, B: int, mode: str = "exact",
                orders=None, generator: torch.Generator | None = None,
                slack: float = 1.05) -> torch.Tensor:
    """Dense control: affinity [R, L, B] -> new assign [R, L] through its
    stable top-K (``jax.lax.top_k``'s ties)."""
    vals, idxs = topk_stable(affinity, K)
    return repartition_topk(vals, idxs, B, mode, orders, generator, slack)
