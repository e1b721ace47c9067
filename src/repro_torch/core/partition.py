"""Partition state for IRLI: R independent assignments of L labels into B
buckets, 2-universal hash initialization, load accounting, and the
device-resident inverted index (padded member matrix ``[R, B, max_load]``,
pad -1). Port of ``repro/core/partition.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Large primes for 2-universal hashing  h(x) = ((a*x + b) mod p) mod B
_P = 2_147_483_647  # Mersenne prime 2^31-1


def hash_init(L: int, B: int, R: int, seed: int = 0,
              device: str | torch.device = "cpu") -> torch.Tensor:
    """2-universal random pooling (paper §3.1). Returns assign [R, L] int32
    — the reference's numpy draw, so the same seed gives the same
    assignment."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, _P, size=(R, 1), dtype=np.int64)
    b = rng.integers(0, _P, size=(R, 1), dtype=np.int64)
    labels = np.arange(L, dtype=np.int64)[None, :]
    assign = ((a * labels + b) % _P) % B
    return torch.from_numpy(assign.astype(np.int32)).to(device)


def loads(assign: torch.Tensor, B: int) -> torch.Tensor:
    """Bucket loads. assign [R, L] -> [R, B] int32."""
    R = assign.shape[0]
    out = torch.zeros((R, B), dtype=torch.int32, device=assign.device)
    return out.scatter_add_(1, assign.long(), torch.ones_like(assign))


@dataclasses.dataclass(frozen=True)
class InvertedIndex:
    """Padded CSR-ish inverted index. members[r, b, j] = label id or -1."""
    members: torch.Tensor   # [R, B, max_load] int32
    load: torch.Tensor      # [R, B] int32
    max_load: int


def build_inverted_index(assign: torch.Tensor, B: int,
                         max_load: int | None = None) -> InvertedIndex:
    """Rebuild the member matrix from an assignment: labels sorted stably by
    bucket id, each one's rank within its bucket, scattered into
    ``[B, max_load]``. max_load defaults to the observed max. A label whose
    rank is past ``max_load`` is dropped (the bucket keeps its first
    ``max_load`` labels in id order)."""
    R, L = assign.shape
    ld = loads(assign, B)
    if max_load is None:
        max_load = int(ld.max())
    sorted_b, order = torch.sort(assign, dim=1, stable=True)   # [R, L]
    start = torch.cumsum(ld, dim=1) - ld                       # [R, B]
    rank = (torch.arange(L, device=assign.device)[None, :]
            - torch.gather(start, 1, sorted_b.long()))
    ok = rank < max_load
    rep = torch.arange(R, device=assign.device)[:, None].expand(R, L)
    members = torch.full((R, B, max_load), -1, dtype=torch.int32,
                         device=assign.device)
    members[rep[ok], sorted_b[ok].long(), rank[ok]] = order[ok].int()
    return InvertedIndex(members=members, load=ld, max_load=max_load)
