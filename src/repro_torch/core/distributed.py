"""Distributed IRLI (paper §5.3): the corpus sharded over P nodes, R reps a
node. Port of ``repro/core/distributed.py`` over ``torch.distributed``.

The reference writes each surface as one ``shard_map`` program over global
arrays with a leading shard dimension. Here the program is SPMD: one
process a shard, every rank calling the same function with its own block
(what ``shard_map`` hands the reference's body after ``_strip_block``:
this shard's members [R, B, ML] and base [L_loc, d] or QuantizedStore) and
the same replicated queries. Every rank gets back the same replicated
:class:`SearchResult` with GLOBAL ids. A shard's index along the corpus
axes is its rank in their process group (:func:`axis_group`); ids are made
global as ``id + shard · L_loc`` (-1 stays -1).

The merge crosses ranks exactly twice a search: ONE all-gather of each
rank's [Q, k] scores (fp32) and ids (int32), packed side by side in one
[Q, 2k] int32 buffer (2·Q·P·k·4 bytes gathered in all), and ONE all-reduce
of the [Q] int32 survivor counts. The global top-k over the gathered
[Q, P·k] scores is ``core/topk.topk_stable``: a tie goes to the smaller
position, the smaller shard, as ``jax.lax.top_k`` does. The first call of
a search function at a shard size also checks, once, that every shard has
the same L_loc (one all-reduce of two int64).

Collectives take the tensors where they lie: on the card over NCCL (one
rank a card) or gloo (several ranks on one card: NCCL refuses two ranks on
one device; gloo in torch 2.11 takes CUDA tensors for ``all_gather`` and
``all_reduce``), on the CPU over gloo.

The static contracts at the end of this module hold the per-shard search
to the no-[Q, L] guarantee and the merge to its two collectives and their
bytes (``python -m repro_torch.launch.audit`` audits the merge in a world
of 4 ranks).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core import search_api as SA
from repro_torch.core.search_api import SearchParams, SearchResult
from repro_torch.core.topk import topk_stable


# ------------------------------------------------------------ collectives --
@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The process group over some axes of a mesh, and this rank's place
    in it: ``index`` is its group rank (the position its block takes in a
    gather), ``size`` the number of ranks along the axes."""
    group: Any
    index: int
    size: int


def axis_group(mesh, axes) -> AxisGroup:
    """One axis: ``mesh.get_group(name)``. A tuple of axes: one group over
    the flattened submesh, made once a mesh with
    ``dist.new_subgroups_by_enumeration`` (every rank makes every
    subgroup, as the call requires) and kept on the mesh object."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = tuple(mesh.mesh_dim_names)
    missing = [a for a in axes if a not in names]
    if missing or not axes:
        raise ValueError(f"axes {axes} are not axes of the mesh {names}")
    cache = mesh.__dict__.setdefault("_irli_axis_groups", {})
    if axes not in cache:
        if len(axes) == 1:
            group = mesh.get_group(axes[0])
        else:
            dims = [names.index(a) for a in axes]
            rest = [i for i in range(len(names)) if i not in dims]
            size = math.prod(int(mesh.mesh.shape[i]) for i in dims)
            rows = mesh.mesh.permute(*rest, *dims).reshape(-1, size)
            group, _ = dist.new_subgroups_by_enumeration(
                [r.tolist() for r in rows])
        cache[axes] = AxisGroup(group, dist.get_rank(group),
                                dist.get_world_size(group))
    return cache[axes]


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every group rank's ``t`` (same shape on each), concatenated along
    ``dim`` in group-rank order: one all-gather."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


# ----------------------------------------------------------- local search --
def _resolve(params: SearchParams, L_loc: int, q_batch: int,
             *, force_compact: bool = False) -> SearchParams:
    """Resolve mode against the PER-SHARD corpus size. The production path
    (shard_search_local / make_production_search) exists for corpora where
    dense would not fit, so it pins compact regardless of auto-resolution."""
    if force_compact:
        if params.mode == "dense":
            raise ValueError("the production sharded path is compact-only "
                             "(dense would materialize [Q, L_loc] per shard)")
        return params.replace(mode="compact")
    return params.resolve(L_loc, q_batch)


def _local_arrays(scorer_params, members, base_shard, queries,
                  params: SearchParams, delta_members, tombstone,
                  cache: SA.PipelineCache | None):
    """Shard-local search -> raw (ids, scores, n_cand) tensors. ``params``
    must already be resolved; ``base_shard`` is this shard's raw [L_loc, d]
    corpus or a QuantizedStore over it."""
    cache = cache if cache is not None else SA.DEFAULT_CACHE
    SA.check_store("distributed search", params, base_shard)
    fn = cache.get(params, base_shard.shape[0], queries.shape[0])
    return fn(scorer_params, members, base_shard, queries, delta_members,
              tombstone)


def local_search(scorer_params, members, base_shard, queries,
                 params: SearchParams | None = None, *,
                 delta_members=None, tombstone=None, epoch: int = 0,
                 cache: SA.PipelineCache | None = None,
                 m=None, tau=None, k=None, loss_kind=None, metric=None,
                 mode=None, topC=None):
    """Single-shard IRLI search: queries [Q, d] against this shard's
    corpus, no collective.

    members: [R, B, ML] local inverted index (ids into base_shard)
    base_shard: [L_loc, d] or a QuantizedStore over it
    delta_members [R, B, DL] / tombstone [L_loc] (optional): this shard's
    streaming delta segments and deletion mask. ``epoch`` is echoed on the
    result.

    Typed path -> :class:`SearchResult` with LOCAL ids (-1 where no
    candidate survived); ``mode="auto"`` resolves from L_loc and the query
    batch. The bare kwargs are a deprecated shim returning the old
    ``(ids, scores)`` tuple (loss_kind is accepted and inert)."""
    if params is None:
        del loss_kind                           # accepted, always inert
        params = SA.params_from_legacy_kwargs(
            "distributed.local_search", m=m, tau=tau, k=k, metric=metric,
            mode=mode, topC=topC)
        r = _resolve(params, base_shard.shape[0], queries.shape[0])
        ids, scores, _ = _local_arrays(scorer_params, members, base_shard,
                                       queries, r, delta_members, tombstone,
                                       cache)
        return ids, scores
    SA.check_params("distributed.local_search", params)
    if any(v is not None for v in (m, tau, k, loss_kind, metric, mode, topC)):
        raise TypeError("pass either SearchParams or legacy kwargs, not both")
    r = _resolve(params, base_shard.shape[0], queries.shape[0])
    ids, scores, n_cand = _local_arrays(scorer_params, members, base_shard,
                                        queries, r, delta_members, tombstone,
                                        cache)
    return SearchResult(ids=ids, scores=scores, n_candidates=n_cand,
                        epoch=epoch, mode=r.mode)


# ------------------------------------------------------------------ merge --
def _globalize(ids: torch.Tensor, shard: int, L_loc: int) -> torch.Tensor:
    """Local ids -> global: ``id + shard · L_loc``; -1 stays -1."""
    return torch.where(ids >= 0, ids + shard * L_loc, ids).to(torch.int32)


def _merge_across_shards(ids, scores, n_cand, k: int, grp: AxisGroup):
    """All-gather the per-shard [Q, k] winners (ids already global) in one
    [Q, 2k] int32 buffer, take the global stable top-k over [Q, P·k], and
    all-reduce the survivor counts -> (ids, scores, n_candidates)."""
    Qn = scores.shape[0]
    packed = torch.cat([scores.to(torch.float32).contiguous().view(
        torch.int32), ids.to(torch.int32)], dim=1)             # [Q, 2k]
    every = all_gather_cat(packed[None], grp.group, dim=0)      # [P, Q, 2k]
    every = every.permute(1, 0, 2)                              # [Q, P, 2k]
    all_scores = every[..., :k].contiguous().view(torch.float32).reshape(
        Qn, -1)
    all_ids = every[..., k:].reshape(Qn, -1)
    best, pos = topk_stable(all_scores, k)
    merged = torch.gather(all_ids, 1, pos)
    total = n_cand.to(torch.int32).clone()
    dist.all_reduce(total, group=grp.group)
    return merged, best, total


class _ShardSizeCheck:
    """Once per shard size: every shard of the group has the same L_loc
    (one all-reduce of [L_loc, -L_loc] with MAX)."""

    def __init__(self):
        self.seen: set = set()

    def __call__(self, L_loc: int, grp: AxisGroup, device) -> None:
        if L_loc in self.seen:
            return
        want = torch.tensor([L_loc, -L_loc], dtype=torch.int64,
                            device=device)
        pair = want.clone()
        dist.all_reduce(pair, op=dist.ReduceOp.MAX, group=grp.group)
        if not bool((pair == want).all()):         # one host read
            raise ValueError(
                f"shards of unequal size: this one {L_loc} rows, the group's "
                f"largest {int(pair[0])} and smallest {-int(pair[1])}")
        self.seen.add(L_loc)


def make_distributed_search(mesh, params: SearchParams | None = None, *,
                            corpus_axes=("data",), epoch: int = 0,
                            cache: SA.PipelineCache | None = None,
                            m=None, tau=None, k=None, loss_kind=None,
                            metric=None, mode=None, topC=None):
    """The sharded search over ``corpus_axes`` with per-shard scorers
    (scorers differ per corpus shard, as in the paper: 8 nodes × R = 4
    distinct models). Ranks along the other axes hold the same shard.

    Typed path: ``make_distributed_search(mesh, SearchParams(...))``
    returns ``search(scorer_params, members, base, queries) ->
    SearchResult`` on every rank, with GLOBAL ids and shard-summed
    n_candidates; each rank passes its shard's scorer, members and base.
    The legacy kwarg form returns the old ``(ids, scores)``-tuple
    function."""
    legacy = params is None
    if legacy:
        del loss_kind
        params = SA.params_from_legacy_kwargs(
            "distributed.make_distributed_search", m=m, tau=tau, k=k,
            metric=metric, mode=mode, topC=topC)
    elif any(v is not None
             for v in (m, tau, k, loss_kind, metric, mode, topC)):
        raise TypeError("pass either SearchParams or legacy kwargs, not both")
    else:
        SA.check_params("distributed.make_distributed_search", params)
    sp = params
    grp = axis_group(mesh, corpus_axes)
    check = _ShardSizeCheck()

    def search(scorer_params, members, base, queries):
        L_loc = int(base.shape[0])
        check(L_loc, grp, queries.device)
        r = _resolve(sp, L_loc, queries.shape[0])
        ids, scores, n_cand = _local_arrays(scorer_params, members, base,
                                            queries, r, None, None, cache)
        gids = _globalize(ids, grp.index, L_loc)
        ids, scores, n_cand = _merge_across_shards(gids, scores, n_cand,
                                                   sp.k, grp)
        if legacy:
            return ids, scores
        return SearchResult(ids=ids, scores=scores, n_candidates=n_cand,
                            epoch=epoch, mode=r.mode)

    return search


def shard_corpus(base, n_shards: int):
    """Host-side: split an [L, d] corpus into [n_shards, L/n_shards, d]
    (the tail past a whole number of shards dropped)."""
    L = base.shape[0]
    per = L // n_shards
    return base[: per * n_shards].reshape(n_shards, per, -1)


# -------------------------------------------------- production-scale path ---
def shard_search_local(scorer_params, members, base_shard, queries,
                       params: SearchParams | None = None, *,
                       q_chunk: int = 512, delta_members=None, tombstone=None,
                       epoch: int = 0,
                       cache: SA.PipelineCache | None = None,
                       m=None, tau=None, k=None, topC=None, loss_kind=None,
                       metric=None):
    """100M-scale per-shard search: the compact pipeline + query chunking.

    Every rank is one of the paper's "nodes": it owns base_shard [L_loc, d]
    (raw fp32 or a QuantizedStore) and a full R-rep inverted index over
    those L_loc vectors; no [Q, L] table is built. Queries run in chunks of
    ``q_chunk`` (a Python loop in the reference's ``lax.map`` place) when
    Q is larger than q_chunk and a multiple of it. Optional
    delta_members / tombstone serve a shard that takes streaming updates.

    Typed path -> :class:`SearchResult` (LOCAL ids); compact-only:
    ``params.mode="dense"`` raises. Legacy kwargs -> old ``(ids,
    scores)``."""
    legacy = params is None
    if legacy:
        del loss_kind                   # serving is loss-agnostic
        params = SA.params_from_legacy_kwargs(
            "distributed.shard_search_local", m=m, tau=tau, k=k,
            metric=metric, mode="compact", topC=topC)
    elif any(v is not None for v in (m, tau, k, topC, loss_kind, metric)):
        raise TypeError("pass either SearchParams or legacy kwargs, not both")
    else:
        SA.check_params("distributed.shard_search_local", params)
    Qn = queries.shape[0]
    chunked = not (Qn <= q_chunk or Qn % q_chunk != 0)
    r = _resolve(params, base_shard.shape[0], q_chunk if chunked else Qn,
                 force_compact=True)

    def chunk(qs):
        return _local_arrays(scorer_params, members, base_shard, qs,
                             r, delta_members, tombstone, cache)

    if not chunked:
        ids, scores, n_cand = chunk(queries)
    else:
        parts = [chunk(queries[s:s + q_chunk])
                 for s in range(0, Qn, q_chunk)]
        ids, scores, n_cand = (torch.cat(t) for t in zip(*parts))
    if legacy:
        return ids, scores
    return SearchResult(ids=ids, scores=scores, n_candidates=n_cand,
                        epoch=epoch, mode="compact")


def make_production_search(mesh, params: SearchParams | None = None, *,
                           epoch: int = 0,
                           cache: SA.PipelineCache | None = None,
                           m=None, tau=None, k=None, topC=None,
                           loss_kind=None, metric=None):
    """The search over EVERY rank of the mesh as a corpus shard (paper
    §5.3 with P = mesh size "nodes"). Each rank passes:

      scorer_params: the replicated stacked R-rep scorer
      members: [R, B, ML] its shard's inverted index
      base:    [L_loc, d] its shard's corpus (or a QuantizedStore)
      queries: [Q, d] replicated

    and its shard is its rank in the group over all the mesh's axes
    (:func:`axis_group`). Typed path: ``make_production_search(mesh,
    SearchParams(...))`` returns ``search(...) -> SearchResult`` with
    GLOBAL ids merged across shards and shard-summed n_candidates;
    compact-only. Legacy kwargs return the old ``(ids, scores)``-tuple
    function."""
    legacy = params is None
    if legacy:
        del loss_kind
        params = SA.params_from_legacy_kwargs(
            "distributed.make_production_search", m=m, tau=tau, k=k,
            metric=metric, mode="compact", topC=topC)
    elif any(v is not None for v in (m, tau, k, topC, loss_kind, metric)):
        raise TypeError("pass either SearchParams or legacy kwargs, not both")
    else:
        SA.check_params("distributed.make_production_search", params)
    sp = params
    grp = axis_group(mesh, tuple(mesh.mesh_dim_names))
    check = _ShardSizeCheck()

    def search(scorer_params, members, base, queries):
        L_loc = int(base.shape[0])
        check(L_loc, grp, queries.device)
        r = _resolve(sp, L_loc, queries.shape[0], force_compact=True)
        ids, scores, n_cand = _local_arrays(scorer_params, members, base,
                                            queries, r, None, None, cache)
        gids = _globalize(ids, grp.index, L_loc)
        ids, scores, n_cand = _merge_across_shards(gids, scores, n_cand,
                                                   sp.k, grp)
        if legacy:
            return ids, scores
        return SearchResult(ids=ids, scores=scores, n_candidates=n_cand,
                            epoch=epoch, mode="compact")

    return search


# ------------------------------------------------------- static contracts --
# The collective schedule documented above (one all-gather of the packed
# [Q, k] winners and one all-reduce of the [Q] survivor counts — nothing
# else crosses shards) as a registered, byte-bounded invariant, plus the
# per-shard no-[Q, L] proof.
from repro_torch.analysis import contracts as _C  # noqa: E402


def _local_compact_fixture():
    from repro_torch.analysis import fixtures as _FX
    return _FX.local_search_compact("compact")


def _local_dense_control():
    from repro_torch.analysis import fixtures as _FX
    return _FX.local_search_compact("dense")


def _production_fixture():
    from repro_torch.analysis import fixtures as _FX
    return _FX.production_search()


_C.register(_C.Contract(
    id="distributed.local_search_compact_no_dense_table",
    site="repro_torch.core.distributed.local_search",
    description="the per-shard serving path in compact mode never builds a "
                "[Q, L_loc] table (dense mode is the control)",
    fixture=_local_compact_fixture,
    checks=[_C.forbid_dims("Q", "L"), _C.require_dims("Q", "C")],
    control=_local_dense_control,
))

_C.register(_C.Contract(
    id="distributed.production_merge_collectives",
    site="repro_torch.core.distributed.make_production_search",
    description="the sharded merge moves ONLY the tiny per-shard winners: "
                "one all-gather of [Q, P, k] scores (f32) + ids (s32) and "
                "one [Q] all-reduce of survivor counts — byte-exact bound, "
                "no other collective kind",
    fixture=_production_fixture,
    checks=[_C.allowed_collectives({
        # scores f32 + ids s32, each [Q, P, k] per rank
        "all-gather": lambda fx: 2 * fx.dims["Q"] * fx.dims["P"]
        * fx.dims["k"] * 4,
        # the [Q] s32 sum of n_candidates (the reference's headroom for an
        # int64 lowering)
        "all-reduce": lambda fx: 8 * fx.dims["Q"],
    })],
    min_devices=2,
))
