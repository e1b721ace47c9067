"""How ``correct`` is decided: the program's answers held against the plain
reference's, over the same queries. The numbers:

``mismatch``  the share of the compared queries whose top-k ids or whose
              n_candidates differ from the reference's. The sound program
              differs only where a sum in another order swaps two near-equal
              logits at the top-m cut (a bucket choice) or two near-equal
              scores at the k' or k cut.
``score_gap`` the widest gap between a returned score and the reference's
              score of the returned id for that query, relative to the
              larger of 1 and the latter; infinite where the id names no
              live row. An id altered where it is made reads here.
``missing``   answers that never came (limit 0).

A cell's file gives the limit of each number it compares.
"""
from __future__ import annotations

import torch


def compare(got: list, want: list, rescored: list) -> dict:
    """The program's answers against the reference's over some calls: each
    of ``got`` and ``want`` a list of (ids [Q, k], scores [Q, k],
    n_candidates [Q]), ``rescored`` a list of the reference's score of each
    id the program returned ([Q, k]; NaN for an id that names no live row)
    -> {"mismatch", "score_gap"}."""
    ids, scores, n_cand = (torch.cat([torch.as_tensor(o[j]).cpu()
                                      for o in got]) for j in range(3))
    ref_ids, ref_n = (torch.cat([torch.as_tensor(o[j]).cpu() for o in want])
                      for j in (0, 2))
    rescored = torch.cat([r.cpu() for r in rescored]).to(torch.float32)
    differs = ((ids != ref_ids).any(dim=1)
               | (n_cand.to(torch.int64) != ref_n.to(torch.int64)))
    gap = ((scores.to(torch.float32) - rescored).abs()
           / rescored.abs().clamp_min(1.0))[ids != -1]
    gap = torch.nan_to_num(gap, nan=torch.inf)
    return {"mismatch": float(differs.float().mean()) if len(ids) else 0.0,
            "score_gap": float(gap.max()) if gap.numel() else 0.0}


def verdict(numbers: dict, limits: dict, missing: int):
    """-> (correct, {name: {"value", "limit"}}): correct when no answer is
    missing and every number is within its limit."""
    out = {name: {"value": numbers[name], "limit": limits[name]}
           for name in limits}
    out["missing"] = {"value": int(missing), "limit": 0}
    ok = all(v["value"] <= v["limit"] for v in out.values())
    return ok, out
