"""Compaction: fold delta segments + tombstones back into a dense base
member matrix. Port of ``repro/stream/compaction.py``.

The rebuild reuses core/partition.build_inverted_index through a sentinel
bucket: every dead slot (tombstoned or never issued) is assigned to an
extra bucket B, the index is built over B + 1 buckets, and the sentinel
column is sliced off. max_load is the largest LIVE bucket load (rounded up
to a multiple of 8), so no live member is ever dropped, which is what makes
compaction exact: each bucket's live member set, and therefore every
candidate frequency and result, is unchanged. Only the sentinel bucket
overflows (it holds every unused and dead slot); ``build_inverted_index``
keeps its first max_load ids in id order and the slice drops them, so the
overflow changes nothing and costs one [R, capacity] sort, as in the
reference.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import partition as PT
from repro_torch.store.quantized import encode
from repro_torch.stream.delta import delta_init


def _round_up(x: int, mult: int = 8) -> int:
    return ((max(x, 1) + mult - 1) // mult) * mult


def compact_snapshot(snap, B: int, pad_multiple: int = 8):
    """StreamSnapshot -> compacted StreamSnapshot (epoch + 1). Never writes
    ``snap``: the caller swaps the returned snapshot in, so readers keep a
    consistent pre-compaction view until the swap."""
    assign = torch.where(snap.tombstone[None, :],
                         torch.full((), B, dtype=snap.assign.dtype,
                                    device=snap.assign.device), snap.assign)
    max_load = _round_up(int(snap.load.max()), pad_multiple)
    idx = PT.build_inverted_index(assign, B + 1, max_load)
    R, _, DL = snap.delta.members.shape
    extra = {}
    if snap.store is not None:
        # re-encode the coarse tier from the fp32 buffer inside the SAME
        # swap: codes never drift from vecs (and append-path codes equal a
        # full encode of the same rows, so this is also exact)
        extra["store"] = encode(snap.vecs, snap.store.dtype, snap.store.block)
    return dataclasses.replace(
        snap,
        members=idx.members[:, :B].contiguous(),
        load=idx.load[:, :B].contiguous(),
        delta=delta_init(R, B, DL, snap.delta.members.device),
        epoch=snap.epoch + 1, **extra)
