"""Plain PyTorch version of the FrequentOnes top-C kernel.

Same contract as the reference's ``freq_topc_ref`` and the CUDA kernel:
count-descending, ties toward the smaller id, -1/0 padding past the
distinct-candidate count.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import topk_stable


def freq_topc_ref(cands: torch.Tensor, *, C: int):
    """cands [Q, C0] int32 (pad -1) -> (ids [Q, C] int32, counts [Q, C] f32)."""
    Q, C0 = cands.shape
    C_eff = min(C, C0)
    s = torch.sort(cands, dim=1).values                       # pads (-1) first
    is_start = torch.ones_like(s, dtype=torch.bool)
    is_start[:, 1:] = s[:, 1:] != s[:, :-1]
    run_id = torch.cumsum(is_start, dim=1) - 1                # [Q, C0] int64
    counts = torch.zeros((Q, C0), dtype=torch.float32, device=cands.device)
    counts.scatter_add_(1, run_id, torch.ones_like(counts))
    score = torch.where(is_start & (s >= 0), torch.gather(counts, 1, run_id),
                        torch.full_like(counts, -1.0))
    top_cnt, top_pos = topk_stable(score, C_eff)
    ids = torch.where(top_cnt > 0, torch.gather(s, 1, top_pos),
                      torch.full_like(top_pos, -1)).to(torch.int32)
    top_cnt = top_cnt.clamp_min(0.0)
    if C_eff < C:                                             # pad to C
        ids = torch.cat([ids, ids.new_full((Q, C - C_eff), -1)], dim=1)
        top_cnt = torch.cat([top_cnt, top_cnt.new_zeros((Q, C - C_eff))],
                            dim=1)
    return ids, top_cnt
