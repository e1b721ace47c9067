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


# ------------------------------------------------------- static contracts --
# The memory contract of the two-stage rerank, as a registered invariant
# (audited by repro_torch.launch.audit).
from repro_torch.analysis import contracts as _C  # noqa: E402


def _int8_fixture():
    from repro_torch.analysis import fixtures as _FX
    return _FX.store_search("int8")


def _fp32_control():
    from repro_torch.analysis import fixtures as _FX
    return _FX.store_search("fp32")


_C.register(_C.Contract(
    id="store.int8_no_fp32_payload",
    site="repro_torch.store.rerank.coarse_stage + refine_stage "
         "(QueryPipeline.search's two-stage rerank)",
    description="with store_dtype='int8' the search holds no fp32 [L, D] "
                "(full decode) and no fp32 [Q, C, D] (full-width gather); "
                "fp32 appears only at the [Q, k', D] refine. The fp32 store "
                "is the control that DOES gather full width",
    fixture=_int8_fixture,
    checks=[
        _C.require_dtype_free("float32", "L", "D"),
        _C.forbid_dims("Q", "C", "D", dtype="float32"),
        _C.require_dims("Q", "kp", "D", dtype="float32"),
    ],
    control=_fp32_control,
))
