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
the card. Row sharding over a mesh is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal


def bag_init(gen: torch.Generator, vocab: int, dim: int,
             dtype=torch.float32, scale: float = 0.01) -> dict:
    """table [vocab, dim] ~ normal · scale on the generator's device."""
    return {"table": _normal(gen, (vocab, dim), scale, dtype)}


def bag_lookup(p, ids):
    """Single-hot lookup: ids [...] -> [..., dim]."""
    return F.embedding(ids, p["table"])


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
