"""Delta segments for the streaming mutable index. Port of
``repro/stream/delta.py``.

Layout mirrors the frozen inverted index: a dense [R, B, DL] int32 member
matrix (pad -1) plus a fill counter [R, B]. New items are appended to the
delta segment of their placed bucket; the query path gathers base + delta
members (core/query.gather_members). Deletions are a [capacity] bool
tombstone mask applied to the gathered candidates before counting.

The functions build new tensors and never write their inputs: the snapshot
swap in mutable_index.py is what makes a mutation atomic for readers.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DeltaState:
    """Append-only per-(rep, bucket) segments. members pad = -1."""
    members: torch.Tensor   # [R, B, DL] int32
    fill: torch.Tensor      # [R, B] int32


def delta_init(R: int, B: int, DL: int,
               device: str | torch.device = "cpu") -> DeltaState:
    return DeltaState(
        members=torch.full((R, B, DL), -1, dtype=torch.int32, device=device),
        fill=torch.zeros((R, B), dtype=torch.int32, device=device))


def delta_append(delta: DeltaState, buckets: torch.Tensor,
                 new_ids: torch.Tensor):
    """Append a batch of placed items to their delta segments, all reps at
    once. buckets [R, n]: each new item's placed bucket per rep (< B);
    new_ids [n]: the global ids being inserted.
    -> (DeltaState, ok 0-d bool): ok is False iff any item would pass the
    end of its segment; then the caller compacts and retries, and discards
    the returned state. The reference's out-of-bounds scatter drops those
    writes; here they are masked (``pos < DL``), so nothing lands in the
    next bucket's segment."""
    R, B, DL = delta.members.shape
    n = new_ids.shape[0]
    dev = delta.members.device
    # rank of each new item among the same-bucket items of THIS batch
    sb, order = torch.sort(buckets.long(), dim=1, stable=True)     # [R, n]
    counts = torch.zeros((R, B), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, sb, torch.ones_like(sb))
    starts = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(n, device=dev)[None, :] - torch.gather(starts, 1, sb)
    pos = torch.gather(delta.fill.long(), 1, sb) + rank
    fits = pos < DL
    rep = torch.arange(R, device=dev)[:, None].expand(R, n)
    members = delta.members.clone()
    members[rep[fits], sb[fits], pos[fits]] = \
        new_ids.to(torch.int32)[order][fits]
    fill = delta.fill + counts.to(torch.int32)
    return DeltaState(members=members, fill=fill), fits.all()


def default_delta_len(capacity: int, n_base: int, B: int,
                      slack: float = 2.0) -> int:
    """Per-(rep, bucket) segment length: the expected extra load a bucket
    (power-of-K keeps inserts balanced, Thm. 2) times slack, plus
    headroom."""
    expected = max(1, (capacity - n_base + B - 1) // B)
    return int(slack * expected) + 8
