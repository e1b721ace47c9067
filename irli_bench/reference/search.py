"""IRLI's search (Alg. 2) in plain PyTorch: the scorer's two layers, the
top-m buckets of each repetition, the probed buckets' members, FrequentOnes
(the topC most frequent candidates, count descending, ties toward the
smaller id), the coarse rerank on int8 codes to k' survivors and the fp32
refine to the top k. Every top-k here breaks ties toward the smaller index.

``precision="tf32"`` is the control: every matrix product takes its inputs
rounded to TF32 (10 mantissa bits, round to nearest even) and sums in
fp32, as the tensor cores do with TF32 on; an l2 score takes the expanded
form whose product TF32 would speed. The reference proper
(``"fp32"``) keeps IEEE fp32 throughout.
"""
from __future__ import annotations

import dataclasses

import torch

_LOW = (1 << 32) - 1


def ieee_matmul() -> None:
    """TF32 off for matrix products on the card (the configuration states
    IEEE fp32 scoring); the CPU has no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32's 10-bit mantissa, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def _mm(a, b, precision: str, *, b_rounded: bool = False):
    """a @ b at ``precision``: TF32 rounds both inputs (``b_rounded``: b
    was rounded once already, as :func:`at_precision` does the weights)."""
    if precision == "tf32":
        a = to_tf32(a)
        b = b if b_rounded else to_tf32(b)
    elif precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    return torch.matmul(a, b)


def order_key(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> int64 in the floats' total order (-inf lowest)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)


def topk_desc(x: torch.Tensor, k: int):
    """Top k along the last axis, values descending, a tie to the smaller
    index -> (values, int64 indices)."""
    pos = torch.arange(x.shape[-1], device=x.device, dtype=torch.int64)
    key = (order_key(x) << 32) | (_LOW - pos)
    top = torch.topk(key, k, dim=-1, sorted=True).values
    idx = _LOW - (top & _LOW)
    return torch.gather(x, -1, idx), idx


def build_members(assign: torch.Tensor, B: int, max_load: int):
    """The inverted index [R, B, max_load] int32 (pad -1): each bucket's
    labels in id order, the first max_load of them."""
    R, L = assign.shape
    members = torch.full((R, B, max_load), -1, dtype=torch.int32,
                         device=assign.device)
    for r in range(R):
        b = assign[r].long()
        order = torch.argsort(b, stable=True)            # ids by bucket
        sb = b[order]
        load = torch.bincount(b, minlength=B)
        start = torch.cumsum(load, 0) - load
        rank = torch.arange(L, device=b.device) - start[sb]
        ok = rank < max_load
        members[r, sb[ok], rank[ok]] = order[ok].to(torch.int32)
    return members


def encode_int8(x: torch.Tensor, block: int):
    """Block-scaled int8: a (row, block) scale max|x|/127 (1/127 for an
    all-zero block), codes round-half-even(x / scale) -> (codes [L, D] int8,
    scales [L, D/block] f32). Made in blocks of 2^20 rows."""
    L, D = x.shape
    codes = torch.empty((L, D), dtype=torch.int8, device=x.device)
    scales = torch.empty((L, D // block), device=x.device)
    for s in range(0, L, 1 << 20):
        xb = x[s:s + (1 << 20)].reshape(-1, D // block, block)
        amax = xb.abs().amax(dim=-1)
        sc = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
        scales[s:s + (1 << 20)] = sc
        codes[s:s + (1 << 20)] = torch.round(xb / sc[..., None]).to(
            torch.int8).reshape(-1, D)
    return codes, scales


def dequant(codes, scales, ids):
    """Rows ``ids`` [...] of the int8 store widened to fp32 [..., D]."""
    block = codes.shape[1] // scales.shape[1]
    return codes[ids].to(torch.float32) * torch.repeat_interleave(
        scales[ids], block, dim=-1)


def refine_depth(k: int, topC: int, refine_k: int = 0) -> int:
    """k': refine_k, or 4k and at least 32 when 0; within [k, topC]."""
    kp = refine_k if refine_k > 0 else max(4 * k, 32)
    return max(k, min(kp, topC))


@dataclasses.dataclass(frozen=True)
class Index:
    """What the reference serves from: the scorer weights, the members it
    built, the codes it encoded."""
    weights: dict
    members: torch.Tensor
    codes: torch.Tensor
    scales: torch.Tensor


def max_load(cfg: dict) -> int:
    """Member slots a bucket: the slack times L/B."""
    return int(cfg["max_load_slack"] * max(1, cfg["n_labels"]
                                           // cfg["n_buckets"]))


def build(inputs: dict, cfg: dict) -> Index:
    """The reference's own index over the harness's inputs: each bucket's
    first max_load members in id order, the corpus's int8 codes."""
    codes, scales = encode_int8(inputs["corpus"], cfg["store_block"])
    return Index(inputs["weights"],
                 build_members(inputs["assign"], cfg["n_buckets"],
                               max_load(cfg)), codes, scales)


def at_precision(index: Index, precision: str) -> Index:
    """The index whose weights the scorer's products read at
    ``precision``: rounded once to TF32 for the control."""
    if precision == "fp32":
        return index
    w = dict(index.weights, w1=to_tf32(index.weights["w1"]),
             w2=to_tf32(index.weights["w2"]))
    return dataclasses.replace(index, weights=w)


def top_buckets(weights: dict, x: torch.Tensor, m: int,
                precision: str = "fp32"):
    """The scorer's top-m buckets of each repetition [R, n, m] int64 for
    rows x [n, d] (weights already at ``precision``: see at_precision)."""
    w = weights
    h = torch.relu(_mm(x, w["w1"], precision, b_rounded=True)
                   + w["b1"][:, None, :])
    logits = _mm(h, w["w2"], precision, b_rounded=True) \
        + w["b2"][:, None, :]
    return topk_desc(logits, m)[1]


def probe(index: Index, q: torch.Tensor, m: int, precision: str = "fp32"):
    """The top-m buckets of each repetition [R, Q, m] int64 (the weights
    of ``at_precision(index, precision)``)."""
    return top_buckets(index.weights, q, m, precision)


def frequent_ones(cands: torch.Tensor, C: int):
    """cands [Q, W] int32 (pad -1) -> the C most frequent ids (count
    descending, a tie to the smaller id) and their counts [Q, C]; -1 and 0
    past the number of distinct ids."""
    s = torch.sort(cands, dim=1).values
    start = torch.ones_like(s, dtype=torch.bool)
    start[:, 1:] = s[:, 1:] != s[:, :-1]
    run = torch.cumsum(start, dim=1) - 1
    counts = torch.zeros(s.shape, dtype=torch.int64, device=s.device)
    counts.scatter_add_(1, run, torch.ones_like(counts))
    cnt = torch.gather(counts, 1, run)
    key = torch.where(start & (s >= 0),
                      (cnt << 32) | (_LOW - s.to(torch.int64)),
                      torch.full_like(cnt, -1))
    top = torch.topk(key, min(C, s.shape[1]), dim=1, sorted=True).values
    real = top >= 0
    ids = torch.where(real, _LOW - (top & _LOW), -1).to(torch.int32)
    n = torch.where(real, top >> 32, 0).to(torch.float32)
    if ids.shape[1] < C:
        pad = C - ids.shape[1]
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        n = torch.nn.functional.pad(n, (0, pad), value=0.0)
    return ids, n


def similarity(q: torch.Tensor, vecs: torch.Tensor, metric: str,
               precision: str = "fp32") -> torch.Tensor:
    """q [Q, D] against gathered rows [Q, C, D] -> [Q, C]: the dot product
    (angular), or -Σ(q - v)² (l2, the direct form). At TF32 the l2 takes
    the form whose product TF32 would speed, -(|q|² - 2 q·v + |v|²)."""
    if metric == "l2":
        if precision == "fp32":
            return -((q[:, None, :] - vecs) ** 2).sum(dim=-1)
        qv = _mm(vecs, q[:, :, None], precision)[..., 0]
        return -((q * q).sum(dim=-1)[:, None] - 2.0 * qv
                 + (vecs * vecs).sum(dim=-1))
    return _mm(vecs, q[:, :, None], precision)[..., 0]


def rescore(index: Index, q: torch.Tensor, ids: torch.Tensor,
            metric: str = "angular") -> torch.Tensor:
    """The reference's score of each returned id [Q, k] for its query, as
    the refine computes it: -inf where the id is -1 (no answer), NaN where
    it names no row."""
    ids = torch.as_tensor(ids).to(q.device).long()
    n_rows = index.codes.shape[0]
    ok = (ids >= 0) & (ids < n_rows)
    safe = torch.where(ok, ids, 0)
    s = similarity(q, dequant(index.codes, index.scales, safe), metric)
    bad = ~ok & (ids != -1)
    s = torch.where(ids == -1, -torch.inf, s)
    return torch.where(bad, torch.nan, s)


def search_block(index: Index, q: torch.Tensor, seen: dict, *, m: int,
                 tau: int, k: int, topC: int, refine_k: int = 0,
                 metric: str = "angular", precision: str = "fp32"):
    """One block of queries -> (ids [Q, k] int32, scores [Q, k] f32,
    n_candidates [Q] int32). ``seen`` gathers the work the queries need:
    the probed (rep, bucket) cells, the rows named by valid coarse slots and
    by refined survivors (bool masks), and the counts of both."""
    R = index.members.shape[0]
    bidx = probe(index, q, m, precision)                        # [R, Q, m]
    rep = torch.arange(R, device=q.device)[:, None, None]
    cands = index.members[rep, bidx]                        # [R, Q, m, ML]
    Q = q.shape[0]
    cands = cands.transpose(0, 1).reshape(Q, -1)
    cid, cnt = frequent_ones(cands, topC)
    valid = (cid >= 0) & (cnt >= tau)
    n_cand = valid.sum(dim=1).to(torch.int32)
    kp = min(refine_depth(k, topC, refine_k), cid.shape[1])
    sim = torch.full(cid.shape, -torch.inf, device=q.device)
    vq, vs = valid.nonzero(as_tuple=True)
    if vq.numel():
        rows = dequant(index.codes, index.scales, cid[vq, vs].long())
        sim[vq, vs] = similarity(q[vq], rows[:, None, :], metric,
                                 precision)[:, 0]
    coarse, pos = topk_desc(sim, kp)
    sid = torch.where(torch.isfinite(coarse), torch.gather(cid, 1, pos),
                      -1)
    vecs = dequant(index.codes, index.scales, sid.clamp_min(0).long())
    fine = torch.where(sid >= 0, similarity(q, vecs, metric, precision),
                       torch.full(sid.shape, -torch.inf, device=q.device))
    scores, fpos = topk_desc(fine, min(k, kp))
    ids = torch.where(torch.isfinite(scores), torch.gather(sid, 1, fpos), -1)
    if ids.shape[1] < k:
        ids = torch.nn.functional.pad(ids, (0, k - ids.shape[1]), value=-1)
        scores = torch.nn.functional.pad(scores, (0, k - scores.shape[1]),
                                         value=-torch.inf)
    seen["cells"].view(-1)[(rep * index.members.shape[1] + bidx)
                           .reshape(-1)] = True
    seen["rows"][cid[valid].long()] = True
    seen["refined_rows"][sid[sid >= 0].long()] = True
    seen["valid"] += int(n_cand.sum())
    seen["refined"] += int((sid >= 0).sum())
    return ids.to(torch.int32), scores, n_cand


def search(index: Index, q: torch.Tensor, *, block: int = 256, **kw):
    """:func:`search_block` over ``q`` in blocks of ``block`` queries ->
    (ids, scores, n_candidates, stats): stats counts the work these queries
    need, as one batch: distinct probed buckets, valid coarse slots, the
    distinct rows they name, refined survivors and their distinct rows.
    A ``mode`` among the keywords is ignored: every mode of the program
    computes this one result."""
    kw.pop("mode", None)
    index = at_precision(index, kw.get("precision", "fp32"))
    R, B, _ = index.members.shape
    L = index.codes.shape[0]
    dev = q.device
    seen = {"cells": torch.zeros((R, B), dtype=torch.bool, device=dev),
            "rows": torch.zeros(L, dtype=torch.bool, device=dev),
            "refined_rows": torch.zeros(L, dtype=torch.bool, device=dev),
            "valid": 0, "refined": 0}
    outs = [search_block(index, q[s:s + block], seen, **kw)
            for s in range(0, q.shape[0], block)]
    stats = {"buckets": int(seen["cells"].sum()), "valid": seen["valid"],
             "rows": int(seen["rows"].sum()), "refined": seen["refined"],
             "refined_rows": int(seen["refined_rows"].sum())}
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]),
            torch.cat([o[2] for o in outs]), stats)
