"""IRLI query path (Alg. 2): score -> top-m buckets per rep -> gather
inverted-index members -> per-candidate frequency across the m·R probed
buckets -> threshold filter -> true-distance re-rank.
Port of ``repro/core/query.py``.

Three frequency/rerank backends behind :class:`QueryPipeline`:

dense  — frequency via a scatter-add into a [Q, L] count table, then the
         masked rerank over all L rows (``rerank_topk``: the distance_topk
         kernel on the card, which never holds the [Q, L] similarities;
         the plain version on the CPU, which does). Memory O(Q·L).
compact— the scorer's output layer and top-m as one call (the irli_topk
         kernel on the card: no [R, Q, B] logits), then FrequentOnes top-C
         per query (``frequency_topC``, the freq_topc kernel on the card)
         and a gathered rerank over just those C rows; with an int8/bf16
         store the two-stage rerank (the quant_rerank kernel, then an exact
         fp32 refine). No [Q, L] table.
mega   — the compact path as ONE launch of the fused mega_query kernel on
         the card (kernels/mega_query); on the CPU, and on the card where
         the kernel cannot serve the request (delta/tombstone state, shapes
         past its shared memory), the compact sequence, with the same
         results.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.network import scorer_hidden, scorer_probs
from repro_torch.core.partition import InvertedIndex
from repro_torch.core.topk import topk_stable
from repro_torch.kernels.distance_topk.ops import rerank_topk
from repro_torch.store.quantized import QuantizedStore


def top_buckets(params: dict, queries: torch.Tensor, m: int,
                loss_kind: str = "softmax_bce"):
    """queries [Q, d] -> (probabilities [R, Q, m], bucket ids [R, Q, m]
    int64): the stable top-m of ``scorer_probs``, as the reference's
    ``jax.lax.top_k`` of the probabilities."""
    return topk_stable(scorer_probs(params, queries, loss_kind), m)


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
    bucket_idx = bucket_idx.long()
    cands = members[rep, bucket_idx]                         # [R, Q, m, ML]
    if delta_members is not None:
        cands = torch.cat([cands, delta_members[rep, bucket_idx]], dim=-1)
    if probe_keep is not None:
        cands = torch.where(probe_keep[..., None], cands,
                            torch.full_like(cands, -1))
    return cands.transpose(0, 1).reshape(Q, -1)


def gather_candidates(index: InvertedIndex, bucket_idx: torch.Tensor,
                      delta_members: torch.Tensor | None = None):
    """bucket_idx [R, Q, m] -> candidate ids [Q, R·m·max_load] (pad -1)."""
    return gather_members(index.members, bucket_idx, delta_members)


def probe_keep_mask(logits: torch.Tensor, top_vals: torch.Tensor,
                    probe_mass: float) -> torch.Tensor:
    """The per-query probe-count policy m(q): keep probe j of a rep iff the
    softmax mass of the probes before it is still short of ``probe_mass``.
    logits [R, Q, B], top_vals [R, Q, m] (descending) -> bool [R, Q, m];
    probe 0 is always kept."""
    return probe_keep_from_lse(top_vals, torch.logsumexp(logits, dim=-1),
                               probe_mass)


def probe_keep_from_lse(top_vals: torch.Tensor, lse: torch.Tensor,
                        probe_mass: float) -> torch.Tensor:
    """:func:`probe_keep_mask` from the rows' log-sum-exp [R, Q] instead of
    the logits — what the fused scorer top-m (kernels/irli_topk) returns, so
    the [R, Q, B] logits need not exist."""
    p = torch.exp(top_vals - lse[..., None])                   # [R, Q, m]
    mass_before = torch.cumsum(p, dim=-1) - p
    return mass_before < probe_mass


def scorer_top_m(params: dict, queries: torch.Tensor, m: int, *,
                 lse: bool = False):
    """The probe: the scorer's top-m buckets per rep -> (their logits
    [R, Q, m] f32 descending, bucket ids [R, Q, m] int32) and, with
    ``lse``, the rows' log-sum-exp [R, Q]. The first layer is a plain
    matmul; the output layer and the top-m are one call of the
    kernels/irli_topk dispatch site (the kernel on the card, which never
    allocates the [R, Q, B] logits)."""
    from repro_torch.kernels.irli_topk.ops import scorer_topk
    w2 = params["w2"]
    h = scorer_hidden(params, queries).to(w2.dtype)
    return scorer_topk(h, w2, params["b2"], m=m, lse=lse)


def predicted_probe_counts(params: dict, queries: torch.Tensor, m: int,
                           probe_mass: float) -> torch.Tensor:
    """Effective probes per (rep, query) under the adaptive-m policy:
    [R, Q] int32 in [1, m] — the keep mask serving applies, summed."""
    vals, _, lse = scorer_top_m(params, queries, m, lse=True)
    keep = probe_keep_from_lse(vals, lse, probe_mass)
    return keep.sum(dim=-1, dtype=torch.int32)


def probe_buckets(params: dict, queries: torch.Tensor, m: int):
    """Just the probe: top-m bucket ids [R, Q, m] int32 per query."""
    return scorer_top_m(params, queries, m)[1]


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


def frequency_filter(freq: torch.Tensor, tau: int) -> torch.Tensor:
    """Keep candidates with count >= tau -> bool mask [Q, L]."""
    return freq >= tau


def auto_tau(freq: torch.Tensor, budget: int) -> torch.Tensor:
    """Beyond-paper: a per-query tau so that about ``budget`` candidates
    survive. freq [Q, L] -> tau [Q]: the budget-th largest count, at least
    1 (the smallest tau with |{freq >= tau}| <= budget on distinct
    counts)."""
    if budget <= 0:
        # without the guard, budget=0 indexes column -1 and silently
        # returns the MINIMUM frequency (i.e. keeps everything)
        raise ValueError(f"auto_tau: budget must be >= 1, got {budget}")
    kth = torch.sort(freq, dim=1, descending=True).values[
        :, min(budget, freq.shape[1]) - 1]
    return kth.clamp_min(1.0)


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
    expansion |q|² - 2q·v + |v|² otherwise). The plain version of the
    distance_topk kernel (dense mode, ``rerank``, the exact oracle) uses it,
    and the kernel keeps its l2 order."""
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


def _kernel_metric(metric: str) -> str:
    return "l2" if metric == "l2" else "dot"


def rerank(queries, base, cand_mask, k: int, metric: str = "angular"):
    """True-distance re-rank of surviving candidates: queries [Q, d], base
    [L, d], cand_mask broadcastable to [Q, L] -> top-k ids [Q, k] int32, -1
    where fewer than k candidates survived. Through ``rerank_topk``: the
    distance_topk kernel on the card, which never builds the [Q, L]
    similarity table."""
    return rerank_topk(queries, base, cand_mask, k=k,
                       metric=_kernel_metric(metric))[1]


def exact_topk(queries, base, tombstone, *, k: int, metric: str = "angular"):
    """Full-probe exact top-k over the fp32 tier — the audit oracle:
    queries [Q, d], base [L, d], tombstone [L] bool -> ids [Q, k] int32 (-1
    where fewer than k live rows exist). The live mask is one row seen by
    every query (a stride-0 view): no [Q, L] array exists on the card."""
    live = ~tombstone
    return rerank(queries, base, live[None, :].expand(queries.shape[0], -1),
                  k, metric)


def query_members(params: dict, members: torch.Tensor, queries, *, m: int,
                  tau: int, L: int, loss_kind: str = "softmax_bce",
                  delta_members: torch.Tensor | None = None,
                  tombstone: torch.Tensor | None = None):
    """Full query path over raw member matrices -> (cand_mask [Q, L] bool,
    freq [Q, L] f32, n_candidates [Q] int32). ``delta_members`` unions the
    streaming delta segments into the gather, ``tombstone`` masks deleted
    ids before counting. Bucket choice is the stable top-m of the
    probabilities, as the reference's."""
    _, bidx = top_buckets(params, queries, m, loss_kind)
    cands = gather_members(members, bidx, delta_members)
    if tombstone is not None:
        cands = mask_tombstones(cands, tombstone)
    freq = candidate_frequencies_dense(cands, L)
    mask = frequency_filter(freq, tau)
    return mask, freq, mask.sum(dim=1, dtype=torch.int32)


def query_index(params: dict, index: InvertedIndex, queries, *, m: int,
                tau: int, L: int, loss_kind: str = "softmax_bce",
                delta_members: torch.Tensor | None = None,
                tombstone: torch.Tensor | None = None):
    """:func:`query_members` over an InvertedIndex's member matrix."""
    return query_members(params, index.members, queries, m=m, tau=tau, L=L,
                         loss_kind=loss_kind, delta_members=delta_members,
                         tombstone=tombstone)


def recall_at(cand_mask: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """recall k@k: the share of ground-truth ids present in the candidate
    mask [Q, L]; gt [Q, k] entries < 0 are ignored -> 0-d f32."""
    valid = gt >= 0
    hits = torch.gather(cand_mask, 1, gt.clamp_min(0).long())
    hits = hits.float() * valid.float()
    return hits.sum() / valid.sum().clamp_min(1)


def precision_at(scores_mask, freq, queries, label_vecs, gt_labels,
                 ks=(1, 3, 5)) -> dict:
    """XML P@k: the stable top-k surviving candidates by frequency against
    the gold labels gt_labels [Q, n] -> {"P@k": 0-d f32}."""
    out = {}
    for k in ks:
        _, top = topk_stable(torch.where(
            scores_mask, freq, torch.full((), -torch.inf,
                                          device=freq.device)), k)
        hit = (top[..., None] == gt_labels[:, None, :]).any(-1)
        out[f"P@{k}"] = hit.float().mean()
    return out


# ------------------------------------------------------------ pipeline ------
DENSE_TABLE_BUDGET_BYTES = 64 << 20   # default cap on the [Q, L] fp32 tables


def select_mode(L: int, q_batch: int = 512,
                budget_bytes: int = DENSE_TABLE_BUDGET_BYTES,
                store_dtype: str = "fp32", *, m: int | None = None,
                topC: int | None = None, refine_k: int | None = None,
                k: int | None = None) -> str:
    """Pick the frequency/rerank backend from the per-shard corpus size:
    "dense" while its two [q_batch, L] fp32 tables fit the budget and the
    store is fp32. Otherwise, when the caller passes the probe/rerank knobs
    (``m``, ``topC``, ``refine_k``, ``k``), "mega" whenever the fused
    kernel's footprint fits the card (kernels/mega_query/ops.mega_fits),
    else "compact"; without the knobs, "compact" (the legacy rule of
    ``QueryPipeline.make``)."""
    dense_fits = (store_dtype == "fp32"
                  and 2 * q_batch * L * 4 <= budget_bytes)
    if dense_fits:
        return "dense"
    if None not in (m, topC, refine_k, k):
        from repro_torch.kernels.mega_query.ops import mega_fits
        if mega_fits(m, topC, refine_k, k):
            return "mega"
    return "compact"


@dataclasses.dataclass(frozen=True)
class QueryPipeline:
    """One query-serving configuration: probe width, frequency threshold,
    rerank depth, the frequency/rerank backend (``mode``) and the vector
    tier (``store_dtype``). See the reference's QueryPipeline for the
    knobs; ``mode="mega"`` serves the compact path as one fused launch
    (kernels/mega_query/ops.mega_search) with the same results.
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
                             "(use 'dense', 'compact', 'mega', or "
                             "make(mode='auto'))")
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

    @classmethod
    def make(cls, L: int, *, mode: str = "auto", q_batch: int = 512,
             budget_bytes: int = DENSE_TABLE_BUDGET_BYTES, **kw):
        """Build a pipeline, resolving mode="auto" from L and the memory
        budget by the legacy rule (:func:`select_mode` without the knobs:
        dense or compact, never mega)."""
        if mode == "auto":
            mode = select_mode(L, q_batch, budget_bytes,
                               kw.get("store_dtype", "fp32"))
        return cls(mode=mode, **kw)

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
        return self._run(lambda _, fn, *args: fn(self, *args), params,
                         members, base, queries, delta_members, tombstone)

    def search_staged(self, params, members, base, queries,
                      delta_members=None, tombstone=None, *, registry=None):
        """Per-stage debug mode of :meth:`search`: the same stage calls,
        each fenced (``obs.trace``: a CUDA synchronise when its output lies
        on the card) and timed into the ``serve_stage_seconds{stage=...}``
        histogram of ``registry`` (default registry when None). Both run
        :meth:`_run`, so the results are bit-identical.

        The stage labels are the reference's. The [R, Q, B] logits are
        never built (2.62 GB at Q = 1024 on the deep1b widths), so
        ``scorer_logits`` times the scorer's first layer
        (``scorer_hidden``) and ``top_m`` times the output GEMM and the
        top-m together (one irli_topk launch on the card). ``mode="mega"``
        is one stage, ``mega``: the ``ops.mega_search`` call, and it counts
        ``serve_mega_dispatch_total``."""
        from repro_torch import obs
        reg = obs.get_registry(registry)

        def timed(stage, fn, *args):
            with obs.trace(reg, "serve_stage_seconds", stage=stage) as sp:
                return sp.fence(fn(self, *args))

        out = self._run(timed, params, members, base, queries, delta_members,
                        tombstone)
        if self.mode == "mega":
            reg.counter("serve_mega_dispatch_total").inc()
        return out

    def _run(self, run, params, members, base, queries, delta_members,
             tombstone):
        """The serving path over the stage units below: ``run(stage, fn,
        *args)`` calls ``fn(self, *args)`` for the stage named ``stage``,
        and :meth:`search_staged`'s also times it."""
        store = self.resolve_store(base)
        if self.mode == "mega":
            return run("mega", _stage_mega, params, members, base, queries,
                       delta_members, tombstone)
        h = run("scorer_logits", _stage_hidden, params, queries)
        bidx, keep = run("top_m", _stage_topm, params, h)
        cands = run("gather", _stage_gather, members, bidx, keep,
                    delta_members, tombstone)
        rows = store.codes if store is not None else base
        if self.mode == "compact":
            cid, cnt, n_cand = run("freq_topc", _stage_freq_topc, cands)
            if store is not None and store.dtype != "fp32":
                cids = run("quant_rerank", _stage_quant_coarse, queries,
                           store, cid, cnt)
                ids, scores = run("refine", _stage_quant_refine, queries,
                                  store, cids)
            else:
                ids, scores = run("rerank", _stage_rerank_gathered, queries,
                                  rows, cid, cnt)
            return ids, scores, n_cand
        freq = run("freq_dense", _stage_freq_dense, cands, rows)
        return run("rerank", _stage_rerank_dense, queries, rows, freq)


# ----------------------------------------------------------- stage units ----
# One function per serving stage, ``fn(pipe, *args)``; QueryPipeline._run
# composes them for both search() and search_staged().

def _stage_mega(pipe: QueryPipeline, params, members, base, queries,
                delta_members, tombstone):
    from repro_torch.kernels.mega_query.ops import mega_search
    return mega_search(pipe, params, members, base, queries, delta_members,
                       tombstone)


def _stage_hidden(pipe: QueryPipeline, params, queries):
    del pipe                                      # uniform (pipe, *args) ABI
    return scorer_hidden(params, queries).to(params["w2"].dtype)


def _stage_topm(pipe: QueryPipeline, params, h):
    """The output layer and the top-m as one irli_topk call -> (bucket ids
    [R, Q, m] int32, probe keep mask [R, Q, m] or None): on the card the
    [R, Q, B] logits are never allocated, and the keep mask comes from the
    kernel's log-sum-exp."""
    from repro_torch.kernels.irli_topk.ops import scorer_topk
    adaptive = pipe.adaptive_m and pipe.probe_mass < 1.0
    out = scorer_topk(h, params["w2"], params["b2"], m=pipe.m, lse=adaptive)
    keep = (probe_keep_from_lse(out[0], out[2], pipe.probe_mass)
            if adaptive else None)
    return out[1], keep


def _stage_gather(pipe: QueryPipeline, members, bidx, probe_keep,
                  delta_members, tombstone):
    del pipe
    cands = gather_members(members, bidx, delta_members,
                           probe_keep=probe_keep)
    if tombstone is not None:
        cands = mask_tombstones(cands, tombstone)
    return cands


def _stage_freq_topc(pipe: QueryPipeline, cands):
    cid, cnt = frequency_topC(cands, pipe.topC)
    n_cand = ((cid >= 0) & (cnt >= pipe.tau)).sum(dim=1)
    return cid, cnt, n_cand.to(torch.int32)


def _stage_rerank_gathered(pipe: QueryPipeline, queries, rows, cid, cnt):
    return rerank_gathered(queries, rows, cid, cnt, pipe.tau, pipe.k,
                           pipe.metric)


def _stage_quant_coarse(pipe: QueryPipeline, queries, store, cid, cnt):
    from repro_torch.store.rerank import coarse_stage
    return coarse_stage(queries, store, cid, cnt, tau=pipe.tau, k=pipe.k,
                        refine_k=pipe.refine_k, metric=pipe.metric)


def _stage_quant_refine(pipe: QueryPipeline, queries, store, cids):
    from repro_torch.store.rerank import refine_stage
    return refine_stage(queries, store, cids, k=pipe.k, metric=pipe.metric)


def _stage_freq_dense(pipe: QueryPipeline, cands, rows):
    del pipe
    return candidate_frequencies_dense(cands, rows.shape[0])


def _stage_rerank_dense(pipe: QueryPipeline, queries, rows, freq):
    mask = freq >= pipe.tau
    scores, ids = rerank_topk(queries, rows, mask, k=pipe.k,
                              metric=_kernel_metric(pipe.metric))
    return ids, scores, mask.sum(dim=1).to(torch.int32)


# ------------------------------------------------------- static contracts --
# The compact path's scalability claim, as registered invariants: proven by
# `python -m repro_torch.launch.audit`. Declared here, beside the entry
# point; the toy fixtures live in repro_torch.analysis.fixtures and build
# lazily at audit time.
from repro_torch.analysis import contracts as _C  # noqa: E402


def _compact_fixture():
    from repro_torch.analysis import fixtures as _FX
    return _FX.query_search("compact")


def _compact_streaming_fixture():
    from repro_torch.analysis import fixtures as _FX
    return _FX.query_search("compact", streaming=True)


def _dense_control():
    from repro_torch.analysis import fixtures as _FX
    return _FX.query_search("dense")


_C.register(_C.Contract(
    id="query.compact_no_dense_table",
    site="repro_torch.core.query.QueryPipeline.search",
    description="compact mode never materializes the [Q, L] count table "
                "(the 100M-scale serving guarantee); dense mode is the "
                "control that MUST build it",
    fixture=_compact_fixture,
    checks=[_C.forbid_dims("Q", "L"), _C.require_dims("Q", "C")],
    control=_dense_control,
))

_C.register(_C.Contract(
    id="query.compact_streaming_no_dense_table",
    site="repro_torch.core.query.QueryPipeline.search (delta + tombstone)",
    description="the streaming path (delta segments unioned, tombstones "
                "dropped) keeps the same no-[Q, L] guarantee",
    fixture=_compact_streaming_fixture,
    checks=[_C.forbid_dims("Q", "L"), _C.require_dims("Q", "C")],
    control=_dense_control,
))


def _audit_oracle_control():
    from repro_torch.analysis import fixtures as _FX
    return _FX.audit_oracle_control()


_C.register(_C.Contract(
    id="query.audit_oracle_off_hot_path",
    site="repro_torch.core.query.exact_topk (ShadowAuditor ground truth)",
    description="the serve pipeline contains no [Q, L] full-probe table — "
                "the exact audit oracle runs strictly off the hot path, on "
                "the sampled shadow window; the oracle's plain full-probe "
                "scan is the control that MUST build the table",
    fixture=_compact_fixture,
    checks=[_C.forbid_dims("Q", "L")],
    control=_audit_oracle_control,
))
