"""Query-aware serving policies fed by live traffic statistics.
Port of ``repro/online/policy.py``.

Two knobs ride on the probe-frequency stream the server already counts
(``serve_bucket_probes``, a [R·B] VectorCounter):

  - **adaptive probe count m(q)** lives in the query pipeline itself
    (core/query.probe_keep_from_lse, SearchParams.adaptive_m /
    probe_mass); the refit loop only reports the predicted counts.
  - **hot-bucket replication** (:func:`build_replicas`): members of the
    most-probed buckets are replicated into their runner-up bucket, so a
    query whose top probe narrowly misses a hot item still retrieves it.
    Replicas are shadow copies: load accounting tracks primary placements
    only, the tombstone masks deleted replicated ids, and the pipeline
    gathers replica segments like delta segments
    (SearchParams.hot_replicas=True).

This runs at refit cadence, off the per-query path. A hot bucket's member
logits are computed on the index's device, with their three largest
values and positions; one host copy a rep brings those back. Where the
three values are strictly decreasing, the reference's ``np.argsort(-
logits)[:, :2]`` is exactly the first two positions; a row with a tie
among them takes ``np.argsort`` on its own host copy, so ties go the
reference's way too.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.network import scorer_logits
from repro_torch.obs.qlog import host


def hot_buckets(probe_counts, R: int, B: int, hot_frac: float) -> np.ndarray:
    """Top-H most-probed buckets per rep, hottest first: [R, H] int.

    ``probe_counts`` is the flat [R·B] (or [R, B]) counter vector — the
    server's ``serve_bucket_probes``, ideally after windowed decay.
    H = max(1, int(hot_frac * B)).
    """
    counts = host(probe_counts, np.float64).reshape(R, B)
    H = max(1, int(hot_frac * B))
    order = np.argsort(-counts, axis=1, kind="stable")
    return order[:, :H]


@torch.no_grad()
def build_replicas(params: dict, vecs: torch.Tensor, members: torch.Tensor,
                   tombstone: torch.Tensor, probe_counts, *,
                   hot_frac: float = 0.05, replica_len: int = 8
                   ) -> torch.Tensor:
    """Replicate hot-bucket members into their second-choice buckets.

    For each rep r and each of its top-H hottest buckets (by probe count),
    every live member id is also written into the replica segment of the
    bucket the rep's scorer ranks NEXT for that id's vector (its runner-up
    placement, or the top choice when the hot bucket itself is not the
    argmax). Segments are [R, B, replica_len] int32 with -1 padding;
    overflow beyond ``replica_len`` is dropped in hotness order.

    Returns the replica matrix on ``members``' device, to hang on the
    artifact / snapshot (``StreamSnapshot.replicas``)."""
    dev = members.device
    mem = host(members)                                  # [R, B, ML]
    R, B, _ = mem.shape
    tomb = host(tombstone)
    hot = hot_buckets(probe_counts, R, B, hot_frac)
    replicas = np.full((R, B, int(replica_len)), -1, np.int32)
    fill = np.zeros((R, B), np.int64)
    for r in range(R):
        # this rep's scorer only: a 1-rep view of the stacked params
        p_r = {k: v[r:r + 1] for k, v in params.items()}
        work = []                            # (hot bucket, ids, logits)
        for b in hot[r]:
            ids = mem[r, b]
            ids = ids[ids >= 0]
            ids = ids[~tomb[ids]]
            if ids.size:
                rows = vecs[torch.from_numpy(ids.astype(np.int64)).to(dev)]
                work.append((b, ids, scorer_logits(p_r, rows)[0]))
        if not work:
            continue
        top = [torch.topk(lg, min(3, B), dim=1) for _, _, lg in work]
        vals = host(torch.cat([t.values for t in top]))
        pos = host(torch.cat([t.indices for t in top]))
        at = 0
        for b, ids, logits in work:
            v, p = vals[at:at + ids.size], pos[at:at + ids.size]
            at += ids.size
            top2 = p[:, :2].copy()
            tied = (v[:, 0] == v[:, 1]) if B < 3 else (
                (v[:, 0] == v[:, 1]) | (v[:, 1] == v[:, 2]))
            for i in np.flatnonzero(tied):          # the reference's order
                top2[i] = np.argsort(-host(logits[i]))[:2]
            second = np.where(top2[:, 0] == b, top2[:, 1], top2[:, 0])
            for i, b2 in zip(ids, second):
                if fill[r, b2] < replica_len:
                    replicas[r, b2, fill[r, b2]] = i
                    fill[r, b2] += 1
    return torch.from_numpy(replicas).to(dev)
