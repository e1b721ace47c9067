"""Partitioning baselines the paper compares against (Fig. 3): k-means,
balanced k-means, signed-random-projection LSH and random (2-universal
hash). Each gives an assignment [L] -> bucket and a query -> bucket rule,
scored through the same candidate / recall harness as IRLI.

Port of ``repro/core/baselines.py``. Every function takes and returns
tensors on the caller's device. The random draws are the reference's own
``np.random.default_rng(seed)`` draws (``choice``, ``normal``,
``integers``), made on the host and moved once, so the same seed starts
both packages from the same centres, planes and buckets. Distances,
argmins (the first minimum, as numpy's) and centre means run as torch ops
on the device: a centre is the ``index_add_`` of its members divided by
their count, and keeps its place where it has none. k-means keeps both of
the reference's distance forms: the direct difference below 2e8 elements,
the expansion in blocks of 4096 rows above it. Balanced k-means' greedy
capacity walk is sequential and stays on the host, as the reference's
numpy loop; its distances and centre update run on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.topk import topk_stable
from repro_torch.kernels import resolve_device

_BLOCK = 4096          # rows of the blocked distance form
_DIRECT_MAX = 2e8      # L·B·d below which the direct form runs


def _initial_centers(base: torch.Tensor, B: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    pick = rng.choice(base.shape[0], B, replace=False)
    return base[torch.from_numpy(pick).to(base.device)].clone()


def _expanded_d2(blk: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """|x|² - 2 x·c + |c|², the reference's expansion, [n, B]."""
    return ((blk ** 2).sum(1)[:, None] - 2 * blk @ centers.T
            + (centers ** 2).sum(1)[None])


def _update_centers(base: torch.Tensor, assign: torch.Tensor,
                    centers: torch.Tensor) -> torch.Tensor:
    """Each centre the mean of its members; a centre with none stays."""
    B = centers.shape[0]
    a = assign.long()
    sums = torch.zeros_like(centers).index_add_(0, a, base)
    count = torch.bincount(a, minlength=B)
    mean = sums / count.clamp(min=1)[:, None].to(base.dtype)
    return torch.where((count > 0)[:, None], mean, centers)


def kmeans_partition(base: torch.Tensor, B: int, iters: int = 25,
                     seed: int = 0):
    """Lloyd's k-means. base [L, d] -> (assign [L] int32, centers [B, d])."""
    centers = _initial_centers(base, B, seed)
    L, d = base.shape
    for _ in range(iters):
        if L * B * d < _DIRECT_MAX:
            d2 = ((base[:, None, :] - centers[None]) ** 2).sum(-1)
            assign = d2.argmin(1).to(torch.int32)
        else:
            assign = torch.cat([_expanded_d2(base[s:s + _BLOCK],
                                             centers).argmin(1)
                                for s in range(0, L, _BLOCK)]).to(torch.int32)
        centers = _update_centers(base, assign, centers)
    return assign, centers


def balanced_kmeans_partition(base: torch.Tensor, B: int, iters: int = 25,
                              seed: int = 0):
    """Capacity-bounded k-means (greedy assignment by distance rank): the
    most confident points first, each to its nearest centre with room
    (capacity ⌈L/B⌉). -> (assign [L] int32, centers [B, d])."""
    L = base.shape[0]
    cap = int(np.ceil(L / B))
    centers = _initial_centers(base, B, seed)
    assign = np.zeros(L, np.int32)
    for _ in range(iters):
        d2 = _expanded_d2(base, centers)
        order = torch.argsort(d2.min(1).values, stable=True).cpu().numpy()
        ranks = torch.argsort(d2, dim=1, stable=True).cpu().numpy()
        load = np.zeros(B, np.int64)
        for i in order:                    # the host walk, point by point
            for b in ranks[i]:
                if load[b] < cap:
                    assign[i] = b
                    load[b] += 1
                    break
        centers = _update_centers(base, torch.from_numpy(assign).to(
            base.device), centers)
    return torch.from_numpy(assign).to(base.device), centers


def _pow2(nbits: int, device) -> torch.Tensor:
    return 2 ** torch.arange(nbits, dtype=torch.int64, device=device)


def lsh_partition(base: torch.Tensor, B: int, seed: int = 0):
    """Signed-random-projection LSH: bucket = the sign bits of ⌈log2 B⌉
    projections, mod B. -> (assign [L] int32, planes [d, nbits] f32)."""
    rng = np.random.default_rng(seed)
    nbits = int(np.ceil(np.log2(B)))
    planes = torch.from_numpy(rng.normal(size=(base.shape[1], nbits)).astype(
        np.float32)).to(base.device)
    bits = (base @ planes > 0).to(torch.int64)
    code = (bits * _pow2(nbits, base.device)[None]).sum(1) % B
    return code.to(torch.int32), planes


def random_partition(L: int, B: int, seed: int = 0,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """A uniform bucket a label: assign [L] int32 on ``device``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, B, L).astype(np.int32)).to(
        resolve_device(device))


# ------------------------------------------------------- query -> buckets ---
def centroid_top_buckets(queries: torch.Tensor, centers: torch.Tensor,
                         m: int, metric: str = "angular") -> torch.Tensor:
    """The m best centres a query -> [Q, m] int64 (best first; a tie to
    the smaller id)."""
    if metric == "angular":
        score = queries @ centers.T
    else:
        score = -_expanded_d2(queries, centers)
    return topk_stable(score, m)[1]


def lsh_top_buckets(queries: torch.Tensor, planes: torch.Tensor, B: int,
                    m: int) -> torch.Tensor:
    """Multi-probe LSH: the query's own code, then the codes with one of
    its lowest-margin bits flipped, lowest first -> [Q, m] int32."""
    proj = queries @ planes
    nbits = planes.shape[1]
    base_bits = (proj > 0).to(torch.int64)
    pow2 = _pow2(nbits, queries.device)[None]
    out = torch.empty((queries.shape[0], m), dtype=torch.int64,
                      device=queries.device)
    out[:, 0] = (base_bits * pow2).sum(1) % B
    margins = torch.argsort(proj.abs(), dim=1, stable=True)
    rows = torch.arange(queries.shape[0], device=queries.device)
    for j in range(1, m):
        flip = base_bits.clone()
        flip[rows, margins[:, (j - 1) % nbits]] ^= 1
        out[:, j] = (flip * pow2).sum(1) % B
    return out.to(torch.int32)


def candidates_from_partition(assign: torch.Tensor, bucket_idx: torch.Tensor,
                              L: int) -> torch.Tensor:
    """Boolean [Q, L] candidate mask: label l is a candidate of query q
    iff q probes l's bucket. One [Q, B] table of probed buckets, read at
    every label's bucket."""
    Q = bucket_idx.shape[0]
    nb = int(max(int(bucket_idx.max()), int(assign[:L].max()))) + 1
    probed = torch.zeros((Q, nb), dtype=torch.bool, device=assign.device)
    probed.scatter_(1, bucket_idx.long(), True)
    return probed[:, assign[:L].long()]


def recall_of_mask(mask: torch.Tensor, gt: torch.Tensor) -> float:
    """The share of the true neighbours gt [Q, k] the mask [Q, L] holds."""
    hits = mask.gather(1, gt.long())
    return int(hits.sum()) / hits.numel()
