"""Plain PyTorch version of the fused sigmoid-BCE loss + gradient kernel.

Same contract as the reference's ``bce_logits_ref`` and the CUDA kernel:
per element the stable loss ``max(x, 0) - x·y + log1p(exp(-|x|))`` and the
analytic gradient ``σ(x) - y``; the weighted form scales row i by
``weights[i mod n]`` and everything by ``scale``.
"""
from __future__ import annotations

import torch


def row_weights(rows: int, weights, device) -> torch.Tensor:
    """[rows] f32: ``weights[i mod n]`` (ones when ``weights`` is None);
    rows must be a multiple of n."""
    if weights is None:
        return torch.ones(rows, dtype=torch.float32, device=device)
    n = weights.shape[0]
    if n < 1 or rows % n:
        raise ValueError(f"{rows} rows are not a multiple of {n} weights")
    return weights.float().repeat(rows // n)


def weighted_bce_ref(logits, targets, weights=None, scale: float = 1.0):
    """logits, targets [rows, B]; weights [n] f32 or None -> (loss, grad):
    loss = scale · Σ_i w[i mod n] · Σ_b loss(i, b) (0-d f32), grad [rows, B]
    f32 = scale · w[i mod n] · (σ(x) - y). Works in place on its own
    temporaries, so at most two [rows, B] of them live at once."""
    x = logits.float()
    y = targets.float()
    w = row_weights(x.shape[0], weights, x.device)
    t = x.abs().neg_().exp_().log1p_()
    t.add_(x.clamp_min(0)).sub_(x * y)
    row = t.sum(dim=-1)                                           # [rows]
    del t
    loss = (row * w).sum() * scale
    grad = torch.sigmoid(x).sub_(y).mul_((w * scale)[:, None])
    return loss, grad


def bce_logits_ref(logits, targets):
    """logits/targets [N, B] -> (mean loss Σ loss / N, dlogits / N): the
    reference's ``bce_logits_ref``."""
    return weighted_bce_ref(logits, targets, None, 1.0 / logits.shape[0])
