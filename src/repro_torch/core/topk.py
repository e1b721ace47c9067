"""The one stable top-k of the port: it replaces every ``jax.lax.top_k``.

``jax.lax.top_k`` breaks ties toward the smaller index, and every kernel
oracle of the reference relies on it. ``torch.topk`` gives no such
guarantee. Here each float32 value and its position are packed into one
unique int64 key, ``order(value) * 2^32 + (2^32 - 1 - position)``, so the
largest keys are the largest values, the smaller position first on a tie,
and ``torch.topk`` over the keys is deterministic.
"""
from __future__ import annotations

import torch

_LOW = (1 << 32) - 1


def float_order_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [-2^31, 2^31) in the floats' total order, the
    one ``jax.lax.top_k`` sorts by (-0.0 below +0.0; NaN is not supported):
    a negative float's magnitude bits are flipped so that it sorts below
    the negatives of smaller magnitude."""
    bits = x.to(torch.float32).view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)


def _topk_keys(x: torch.Tensor, k: int):
    n = x.shape[-1]
    if n >= (1 << 32):
        raise ValueError(f"top-k axis of {n} positions does not fit the key")
    pos = torch.arange(n, device=x.device, dtype=torch.int64)
    key = (float_order_key(x) << 32) | (_LOW - pos)
    top = torch.topk(key, k, dim=-1, sorted=True).values
    idx = _LOW - (top & _LOW)
    return torch.gather(x, -1, idx), idx


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis of a float32 tensor -> (values, indices
    int64), values descending, ties toward the smaller index.

    A plain ``torch.topk`` of k+1 values decides every row whose k+1 best
    values all differ: its top-k is unique. Only the rows with two equal
    values among them (pads, -inf slots, repeated rows) take the packed
    keys, so the common case moves the float tensor once."""
    n = x.shape[-1]
    kk = min(k + 1, n)
    vals, idx = torch.topk(x, kk, dim=-1, sorted=True)
    tied = (vals[..., 1:] == vals[..., :-1]).any(dim=-1)
    vals, idx = vals[..., :k].contiguous(), idx[..., :k].contiguous()
    if bool(tied.any()):
        rows = tied.reshape(-1)
        tv, ti = _topk_keys(x.reshape(-1, n)[rows], k)
        vals.view(-1, k)[rows] = tv
        idx.view(-1, k)[rows] = ti
    return vals, idx
