"""IRLI query path (Alg. 2): score -> top-m buckets per rep -> gather
inverted-index members -> per-candidate frequency across the m·R probed
buckets -> threshold filter -> true-distance re-rank.
Port of ``repro/core/query.py``.

Two frequency/rerank backends behind :class:`QueryPipeline`:

dense  — frequency via a scatter-add into a [Q, L] count table and a full
         [Q, L] similarity matrix for the rerank. Memory O(Q·L).
compact— FrequentOnes top-C per query (``frequency_topC``, the freq_topc
         kernel on the card), then a gathered rerank over just those C
         rows; with an int8/bf16 store the two-stage rerank (the
         quant_rerank kernel, then an exact fp32 refine). No [Q, L] table.

The reference's third backend, ``mode="mega"`` (the whole compact path as
one fused launch), comes with the next slice of the port: here it raises.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.network import scorer_logits
from repro_torch.core.topk import topk_stable
from repro_torch.store.quantized import QuantizedStore


def gather_members(members: torch.Tensor, bucket_idx: torch.Tensor,
                   delta_members: torch.Tensor | None = None,
                   probe_keep: torch.Tensor | None = None) -> torch.Tensor:
    """Gather probed-bucket member lists from raw member matrices.

    members [R, B, ML], bucket_idx [R, Q, m], optional delta_members
    [R, B, DL] (streaming delta segments, appended per probed bucket),
    optional probe_keep [R, Q, m] bool (the adaptive-m(q) policy: a
    masked-out probe contributes -1 pads). Returns candidate ids
    [Q, R·m·(ML[+DL])] int32 (pad -1), in the reference's order.
    """
    R, Q, m = bucket_idx.shape
    rep = torch.arange(R, device=members.device)[:, None, None]
    cands = members[rep, bucket_idx]                         # [R, Q, m, ML]
    if delta_members is not None:
        cands = torch.cat([cands, delta_members[rep, bucket_idx]], dim=-1)
    if probe_keep is not None:
        cands = torch.where(probe_keep[..., None], cands,
                            torch.full_like(cands, -1))
    return cands.transpose(0, 1).reshape(Q, -1)


def probe_keep_mask(logits: torch.Tensor, top_vals: torch.Tensor,
                    probe_mass: float) -> torch.Tensor:
    """The per-query probe-count policy m(q): keep probe j of a rep iff the
    softmax mass of the probes before it is still short of ``probe_mass``.
    logits [R, Q, B], top_vals [R, Q, m] (descending) -> bool [R, Q, m];
    probe 0 is always kept."""
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)        # [R, Q, 1]
    p = torch.exp(top_vals - lse)                              # [R, Q, m]
    mass_before = torch.cumsum(p, dim=-1) - p
    return mass_before < probe_mass


def mask_tombstones(cands: torch.Tensor,
                    tombstone: torch.Tensor) -> torch.Tensor:
    """Replace tombstoned candidate ids with -1 before frequency counting.
    cands [Q, C] (pad -1), tombstone [L_cap] bool."""
    dead = tombstone[cands.clamp_min(0).long()] & (cands >= 0)
    return torch.where(dead, torch.full_like(cands, -1), cands)


def candidate_frequencies_dense(cands: torch.Tensor, L: int) -> torch.Tensor:
    """[Q, C] padded candidate ids -> [Q, L] float32 occurrence counts."""
    valid = cands >= 0
    freq = torch.zeros((cands.shape[0], L), dtype=torch.float32,
                       device=cands.device)
    return freq.scatter_add_(1, cands.clamp_min(0).long(), valid.float())


def sorted_frequency_topC(cands: torch.Tensor, C: int):
    """FrequentOnes by per-query sort + run-length count, in plain PyTorch:
    cands [Q, C0] (pad -1) -> (ids [Q, C] int32, counts [Q, C] f32)."""
    from repro_torch.kernels.freq_topc.ref import freq_topc_ref
    return freq_topc_ref(cands, C=C)


def frequency_topC(cands: torch.Tensor, C: int):
    """FrequentOnes over gathered candidates -> compact (ids, counts)
    [Q, C]. Dispatches through kernels/freq_topc/ops, the one dispatch
    site: the CUDA kernel for a tensor on the card, the plain version on the
    CPU. Count descending, ties toward the smaller id, -1/0 padding."""
    from repro_torch.kernels.freq_topc.ops import frequent_topc
    return frequent_topc(cands, C=C)


def pairwise_sim(queries, base, metric: str = "angular") -> torch.Tensor:
    """Similarity of every query against every base row: [Q, d]×[L, d] ->
    [Q, L] fp32 (dot product for angular, negative squared L2 by the
    expansion |q|² - 2q·v + |v|² otherwise). Dense mode and the exact
    oracle use it."""
    base = base.to(torch.float32)
    if metric == "angular":
        return queries @ base.T
    return -((queries ** 2).sum(1, keepdim=True) - 2 * queries @ base.T
             + (base ** 2).sum(1)[None, :])


def gathered_sim(queries, vecs, metric: str = "angular") -> torch.Tensor:
    """The metric for per-query gathered rows: queries [Q, d], vecs
    [Q, C, d] -> [Q, C] fp32. l2 uses the direct difference form -Σ(q-v)²,
    which does not cancel at large norms as the expansion does: this is the
    exact final rerank and must resolve near-duplicate rows."""
    vecs = vecs.to(torch.float32)
    if metric == "l2":
        return -((queries[:, None, :] - vecs) ** 2).sum(dim=-1)
    return torch.bmm(vecs, queries[:, :, None])[..., 0]


def rerank_gathered(queries, base, cand_ids, cand_counts, tau: int, k: int,
                    metric: str = "angular"):
    """Re-rank a compact candidate list: gather base rows by id and score.
    queries [Q,d], base [L,d], cand_ids [Q,C] (-1 pad), cand_counts [Q,C]
    -> (ids [Q,k] int32, scores [Q,k] f32); -1 where no candidate
    survived."""
    valid = (cand_ids >= 0) & (cand_counts >= tau)
    vecs = base[cand_ids.clamp_min(0).long()]                   # [Q, C, d]
    sim = torch.where(valid, gathered_sim(queries, vecs, metric),
                      torch.full(valid.shape, -torch.inf,
                                 device=valid.device))
    scores, pos = topk_stable(sim, k)
    ids = torch.gather(cand_ids, 1, pos)
    ids = torch.where(torch.isfinite(scores), ids, torch.full_like(ids, -1))
    return ids.to(torch.int32), scores


def rerank(queries, base, cand_mask, k: int, metric: str = "angular"):
    """True-distance re-rank of surviving candidates: queries [Q, d], base
    [L, d], cand_mask [Q, L] -> top-k ids [Q, k] int32, -1 where fewer than
    k candidates survived."""
    sim = torch.where(cand_mask, pairwise_sim(queries, base, metric),
                      torch.full(cand_mask.shape, -torch.inf,
                                 device=cand_mask.device))
    scores, idx = topk_stable(sim, k)
    return torch.where(torch.isfinite(scores), idx,
                       torch.full_like(idx, -1)).to(torch.int32)


def exact_topk(queries, base, tombstone, *, k: int, metric: str = "angular"):
    """Full-probe exact top-k over the fp32 tier — the audit oracle. Builds
    the whole [Q, L] similarity table; never on the serving path."""
    return rerank(queries, base, ~tombstone[None, :], k, metric)


# ------------------------------------------------------------ pipeline ------
DENSE_TABLE_BUDGET_BYTES = 64 << 20   # default cap on the [Q, L] fp32 tables


def select_mode(L: int, q_batch: int = 512,
                budget_bytes: int = DENSE_TABLE_BUDGET_BYTES,
                store_dtype: str = "fp32") -> str:
    """Pick the frequency/rerank backend from the per-shard corpus size:
    "dense" while its two [q_batch, L] fp32 tables fit the budget and the
    store is fp32, else "compact". Unlike the reference, this never
    resolves "mega": the fused backend comes with the next slice."""
    dense_fits = (store_dtype == "fp32"
                  and 2 * q_batch * L * 4 <= budget_bytes)
    return "dense" if dense_fits else "compact"


@dataclasses.dataclass(frozen=True)
class QueryPipeline:
    """One query-serving configuration: probe width, frequency threshold,
    rerank depth, the frequency/rerank backend (``mode``) and the vector
    tier (``store_dtype``). See the reference's QueryPipeline for the
    knobs; ``mode="mega"`` raises NotImplementedError in :meth:`search`.
    """
    m: int = 5
    tau: int = 1
    k: int = 10
    mode: str = "compact"          # "dense" | "compact" | "mega"
    topC: int = 1024               # compact candidate budget per query
    metric: str = "angular"
    store_dtype: str = "fp32"      # "fp32" | "int8" | "bf16"
    refine_k: int = 0              # exact-refine depth k' (0 = auto)
    adaptive_m: bool = False       # per-query m(q): see probe_keep_mask
    probe_mass: float = 1.0        # 1.0 keeps every probe

    def __post_init__(self):
        if self.mode not in ("dense", "compact", "mega"):
            raise ValueError(f"unknown pipeline mode {self.mode!r} "
                             "(use 'dense' or 'compact')")
        if self.store_dtype not in ("fp32", "int8", "bf16"):
            raise ValueError(f"unknown store_dtype {self.store_dtype!r} "
                             "(use 'fp32', 'int8', or 'bf16')")
        if not 0.0 < self.probe_mass <= 1.0:
            raise ValueError(f"probe_mass must be in (0, 1], got "
                             f"{self.probe_mass!r}")
        if self.mode == "dense" and self.store_dtype != "fp32":
            raise ValueError(
                "mode='dense' requires store_dtype='fp32' — the dense "
                "rerank would decode the whole [L, D] store back to fp32")

    # -------------------------------------------------------------- stages --
    def top_m(self, logits: torch.Tensor):
        """Top-m buckets per rep from raw logits [R, Q, B] -> (bucket ids
        [R, Q, m], probe keep mask [R, Q, m] or None)."""
        vals, bidx = topk_stable(logits, self.m)
        keep = (probe_keep_mask(logits, vals, self.probe_mass)
                if self.adaptive_m and self.probe_mass < 1.0 else None)
        return bidx, keep

    def candidates(self, params, members, queries, delta_members=None,
                   tombstone=None):
        """Probe + gather: top-m buckets per rep -> flat candidate ids
        [Q, R·m·(ML[+DL])] (pad -1), with delta union, tombstone masking
        and (``adaptive_m``) per-query probe truncation."""
        bidx, keep = self.top_m(scorer_logits(params, queries))
        cands = gather_members(members, bidx, delta_members, probe_keep=keep)
        if tombstone is not None:
            cands = mask_tombstones(cands, tombstone)
        return cands

    def resolve_store(self, base):
        """Validate ``base`` against ``store_dtype``; return the
        QuantizedStore if one was passed, else None."""
        store = base if isinstance(base, QuantizedStore) else None
        if store is not None and store.dtype != self.store_dtype:
            raise ValueError(
                f"pipeline store_dtype={self.store_dtype!r} but the passed "
                f"store holds {store.dtype!r} codes")
        if store is None and self.store_dtype != "fp32":
            raise ValueError(
                f"pipeline store_dtype={self.store_dtype!r} needs a "
                "QuantizedStore base, got a raw array — encode it first "
                "(repro_torch.store.quantized.encode)")
        return store

    def search(self, params, members, base, queries, delta_members=None,
               tombstone=None):
        """Full serving path -> (ids [Q, k] int32 with -1 pad, scores [Q, k]
        float32, n_candidates [Q] int32). ``base`` is a raw [L, d] tensor or
        a QuantizedStore over the same rows."""
        store = self.resolve_store(base)
        if self.mode == "mega":
            raise NotImplementedError(
                "mode='mega' (the fused single-launch query kernel) comes "
                "with the next slice of the port, together with irli_topk; "
                "use mode='compact'")
        cands = self.candidates(params, members, queries, delta_members,
                                tombstone)
        rows = store.codes if store is not None else base
        if self.mode == "compact":
            cid, cnt = frequency_topC(cands, self.topC)
            if store is not None and store.dtype != "fp32":
                from repro_torch.store.rerank import rerank_two_stage
                ids, scores = rerank_two_stage(
                    queries, store, cid, cnt, tau=self.tau, k=self.k,
                    refine_k=self.refine_k, metric=self.metric)
            else:
                ids, scores = rerank_gathered(queries, rows, cid, cnt,
                                              self.tau, self.k, self.metric)
            n_cand = ((cid >= 0) & (cnt >= self.tau)).sum(dim=1)
            return ids, scores, n_cand.to(torch.int32)
        freq = candidate_frequencies_dense(cands, rows.shape[0])
        mask = freq >= self.tau
        sim = torch.where(mask, pairwise_sim(queries, rows, self.metric),
                          torch.full(mask.shape, -torch.inf,
                                     device=mask.device))
        scores, ids = topk_stable(sim, self.k)
        ids = torch.where(torch.isfinite(scores), ids,
                          torch.full_like(ids, -1))
        return (ids.to(torch.int32), scores,
                mask.sum(dim=1).to(torch.int32))
