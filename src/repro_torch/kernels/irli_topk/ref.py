"""Plain PyTorch version of the fused scorer GEMM + top-m kernel.

Same contract as the reference's ``irli_topk_ref`` and the CUDA kernel:
logits = h @ w2 + b2 accumulated in fp32 (bf16 inputs are widened first),
the top-m by value descending with the smaller index first on a tie
(``core/topk.topk_stable``), indices int32.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import topk_stable


def irli_topk_ref(h, w2, b2, *, m: int, lse: bool = False):
    """h [.., Q, H], w2 [.., H, B], b2 [.., B] -> (vals [.., Q, m] f32,
    idx [.., Q, m] int32), plus lse [.., Q] f32 = log Σ_b exp(logit) when
    ``lse``. Builds the whole [.., Q, B] logits."""
    logits = torch.matmul(h.float(), w2.float()) + b2.float()[..., None, :]
    vals, idx = topk_stable(logits, m)
    out = (vals, idx.to(torch.int32))
    if lse:
        out += (torch.logsumexp(logits, dim=-1),)
    return out


def near(a, b, tol: float):
    """|a - b| <= tol + tol·|b|: the kernel-vs-plain tolerance for fp32
    values summed in another order."""
    return (a - b).abs() <= tol + tol * b.abs()


def same_topm(vals, idx, ref_vals, ref_idx, tol: float = 1e-5):
    """The kernel-vs-plain rule for a top-m: ``ref_vals``/``ref_idx`` are
    the plain top-(m+1) (or top-m when m = B). Values agree position by
    position within :func:`near`. Ids are equal in every row, except (a)
    rows whose plain m-th and (m+1)-th values are near, which may hold
    another id at the cut, and (b) rows with two near values inside the
    top-m, which may order them otherwise (their id sets must agree).
    Returns (rows exempt by (a), rows in another order); raises
    AssertionError on a breach."""
    m = vals.shape[-1]
    vals, idx = vals.reshape(-1, m), idx.reshape(-1, m).long()
    wide_v = ref_vals.reshape(vals.shape[0], -1)
    wide_i = ref_idx.reshape(vals.shape[0], -1).long()
    rv, ri = wide_v[:, :m], wide_i[:, :m]
    if not bool(near(vals, rv, tol).all()):
        bad = int((~near(vals, rv, tol)).any(dim=1).sum())
        raise AssertionError(f"{bad} rows hold values off the plain top-m")
    cut = (near(wide_v[:, m - 1], wide_v[:, m], tol)
           if wide_v.shape[1] > m
           else torch.zeros(len(rv), dtype=torch.bool, device=rv.device))
    order = (near(rv[:, :-1], rv[:, 1:], tol).any(dim=1) if m > 1
             else torch.zeros_like(cut)) & ~cut
    same = (idx == ri).all(dim=1)
    same_set = (torch.sort(idx, dim=1).values
                == torch.sort(ri, dim=1).values).all(dim=1)
    bad = ~cut & ~same & ~(order & same_set)
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} rows hold other ids than "
                             f"the plain top-m outside the near ties")
    return int(cut.sum()), int((~same & ~cut).sum())
