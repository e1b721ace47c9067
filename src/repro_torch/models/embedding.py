"""EmbeddingBag and the sparse-feature embedding substrate of the recsys
family.

Port of ``repro/models/embedding.py``. Layouts, as in the reference:

  - single-hot fields: ids [B, n_fields] -> [B, n_fields, dim]
    (:func:`bag_lookup`, ``F.embedding`` like ``jnp.take``);
  - multi-hot bags in CSR form: values [nnz], segment_ids [nnz] ->
    [n_bags, dim] with sum, mean or max (:func:`bag_reduce`, plain
    ``index_add_`` / ``scatter_reduce_``);
  - one mega-table of every field with int32 offsets
    (:func:`tables_init`, :func:`tables_lookup`).

The padded form [N, P] (pad -1) with per-slot weights is
``kernels/embedding_bag/ops.bag_lookup_reduce``: the hand-written kernel on
the card.

A table split on its rows over a mesh (a DTensor, the CTR cells' item and
mega-tables, ``Shard(0)`` on the axes its spec names) is never read whole:
inside ``models.module.on_batch_rows`` each rank gathers the ids of the
rows it serves over the table's axes (``batch_rows`` gives the batch's
layout), looks up those that fall in its own block from its local tensor
(rebased to the block; the others read nothing), and the partial rows are
summed onto the batch's layout (a reduce-scatter over the axes the rows
are split on, an all-reduce over the others). The table's gradient stays
on its block: partial only over the axes where the table is whole and the
rows are split (``to_local(grad_placements=)``, as ``attention.
_attend_mesh`` does). :func:`rows_reduce` runs a padded bag sum (the
embedding_bag kernel) on each rank's own bags from their looked-up rows,
one launch a rank. :func:`dtensor_lookup` is the same lookup at DTensor
ids (the LM's token embedding on a mesh, ``models/transformer._embed``),
its rows returned in the ids' layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal
from repro_torch.models.module import (batch_rows, is_row_sharded,
                                       local_block, rows_dtensor,
                                       rows_partial)


def bag_init(gen: torch.Generator, vocab: int, dim: int,
             dtype=torch.float32, scale: float = 0.01) -> dict:
    """table [vocab, dim] ~ normal · scale on the generator's device."""
    return {"table": _normal(gen, (vocab, dim), scale, dtype)}


def bag_lookup(p, ids):
    """Single-hot lookup: ids [...] -> [..., dim]; a table split on its
    rows is read by :func:`sharded_lookup`."""
    if is_row_sharded(p["table"]):
        return sharded_lookup(p["table"], ids)
    return F.embedding(ids, p["table"])


def _block_plan(table, rows=None):
    """A row-sharded table against the batch's layout (``rows``, else
    :func:`batch_rows`) -> (the rank's block as a local tensor (its
    gradient placements: see the module docstring), its first global row,
    the batch's layout, the placements of the ids gathered over the
    table's axes, those of the partial rows)."""
    from torch.distributed.tensor import Partial, Replicate
    mesh, pl, n = rows or batch_rows()
    axes = {i for i, p in enumerate(table.placements)
            if getattr(p, "dim", None) == 0}
    gathered = [Replicate() if i in axes else p for i, p in enumerate(pl)]
    partial = [Partial() if i in axes else p for i, p in enumerate(pl)]
    grad = [p if i in axes else q for i, (p, q) in enumerate(
        zip(table.placements, rows_partial(pl)))]
    _, offset = local_block(table.shape, mesh, table.placements)
    return (table.to_local(grad_placements=grad), int(offset[0]),
            (mesh, pl, n), gathered, partial)


def _gather(t, rows, gathered):
    """This rank's rows ``t`` -> the rows of every rank of the table's
    axes (the batch's layout ``rows``, gathered as ``gathered``)."""
    return rows_dtensor(t, rows).redistribute(rows[0], gathered).to_local()


def _reduce(part, rows, partial):
    """Each rank's partial rows (laid out as ``partial``) -> their sum on
    this rank's rows of the batch's layout ``rows``."""
    mesh, pl, n = rows
    return rows_dtensor(part, (mesh, partial, n)).redistribute(
        mesh, pl).to_local()


def sharded_lookup(table, ids, rows=None):
    """``F.embedding(ids, table)`` of a row-sharded DTensor table [V, D] on
    this rank's ids [n_loc, ...] (inside ``on_batch_rows``, or of a batch
    laid out as ``rows``) -> its local rows [n_loc, ..., D]: each rank
    looks up the gathered ids that fall in its block; the partial rows are
    summed onto the batch's layout."""
    local, lo, rows, gathered, partial = _block_plan(table, rows)
    every = _gather(ids, rows, gathered)
    inside = (every >= lo) & (every < lo + local.shape[0])
    if local.shape[0]:
        part = F.embedding(torch.where(inside, every - lo, 0), local)
        part = torch.where(inside[..., None], part, 0)
    else:                     # an empty block (ceil(V / n) rows a block)
        part = local.new_zeros((*every.shape, local.shape[1]))
    return _reduce(part, rows, partial)


def dtensor_lookup(table, ids):
    """``F.embedding(ids, table)`` of a row-sharded DTensor table [V, D] at
    DTensor ids [n, ...] (split on their first dimension or whole) ->
    DTensor rows [n, ..., D] in the ids' layout: :func:`sharded_lookup` of
    the ids' local block. No rank gathers the table."""
    rows = (ids.device_mesh, tuple(ids.placements), ids.shape[0])
    return rows_dtensor(sharded_lookup(table, ids.to_local(), rows), rows)


def rows_reduce(table, ids, weights, reduce, rows=None):
    """``reduce(ids, weights, table)`` -> [N, D], a padded weighted bag sum
    (``kernels/embedding_bag/ops.bag_lookup_reduce``'s contract: ids [N, P],
    pad -1), over a whole table. Over a row-sharded DTensor table (inside
    ``on_batch_rows``) it sums this rank's own bags from their looked-up
    rows [N, P, D] (``rows``, the caller's :func:`sharded_lookup` of
    ``ids``, else made here): one ``reduce`` over the rows as a table of
    N·P, each slot its own row. A launch on the card then walks this
    rank's N·P slots only; summing each rank's block over every gathered
    bag would walk all the ranks' slots on every rank (each block holds
    1/n of them)."""
    if not is_row_sharded(table):
        return reduce(ids, weights, table)
    if rows is None:
        rows = sharded_lookup(table, ids)
    n, P = ids.shape
    slots = torch.arange(n * P, dtype=torch.int32,
                         device=ids.device).view(n, P)
    return reduce(torch.where(ids >= 0, slots, -1), weights,
                  rows.reshape(n * P, rows.shape[-1]))


def bag_reduce(p, values, segment_ids, n_bags: int, *, mode: str = "sum",
               weights=None):
    """Multi-hot bag lookup + segment reduction.

    values [nnz] row ids, segment_ids [nnz] bag index (sorted or not),
    weights optional [nnz] per-sample weights -> [n_bags, dim]. An empty
    bag gives 0 for sum and mean and -inf for max (``segment_max``'s
    identity)."""
    if mode not in ("sum", "mean", "max"):
        raise ValueError(mode)
    rows = bag_lookup(p, values)                                # [nnz, dim]
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    seg = segment_ids.long()
    shape = (n_bags, rows.shape[-1])
    if mode == "max":
        out = torch.full(shape, float("-inf"), dtype=rows.dtype,
                         device=rows.device)
        return out.scatter_reduce_(0, seg[:, None].expand_as(rows), rows,
                                   "amax")
    s = torch.zeros(shape, dtype=rows.dtype, device=rows.device)
    s.index_add_(0, seg, rows)
    if mode == "sum":
        return s
    cnt = torch.zeros(n_bags, dtype=rows.dtype, device=rows.device)
    cnt.index_add_(0, seg, torch.ones_like(seg, dtype=rows.dtype))
    return s / cnt.clamp_min(1.0)[:, None]


# --------------------------------------------------- multi-table frontend ---
def tables_init(gen: torch.Generator, vocab_sizes: list[int], dim: int,
                dtype=torch.float32):
    """All fields' tables as ONE [sum(vocab), dim] mega-table with static
    int32 per-field offsets -> ({"mega": {"table"}}, offsets [n_fields])."""
    sizes = torch.tensor([0, *vocab_sizes[:-1]], dtype=torch.int64)
    offsets = torch.cumsum(sizes, 0).to(torch.int32).to(gen.device)
    return {"mega": bag_init(gen, int(sum(vocab_sizes)), dim, dtype)}, offsets


def tables_lookup(p, offsets, ids):
    """ids [B, n_fields] (one id per field) -> [B, n_fields, dim]."""
    return bag_lookup(p["mega"], ids + offsets[None, :])
