"""Gradient compression for a slow all-reduce hop, with error feedback.
Port of ``repro/optim/compression.py``.

Two schemes, both with error feedback (EF: the residual of compression is
added back into the next step's gradient [Karimireddy et al.,
arXiv:1901.09847]):

  - int8 stochastic-rounding quantization (a per-tensor scale);
  - top-k sparsification (keep the largest |g|, EF carries the rest).

``compress_grads`` -> (payload, decompress, new EF); ``compressed_psum``
sums the payload over one axis of a DeviceMesh (``torch.distributed``
all-reduces on ``mesh.get_group(axis)``) and decompresses it.

As in the reference, the int8 payload is summed as int32 (the sum of
int8 codes over the axis overflows int8) and scaled by the mean of the
ranks' scales. So the int8 payload on the wire is int32: as many bytes as
the fp32 gradient, not the 4x fewer that the reference's docstring
claims, and top-k's payload is a dense fp32 carrier of the kept values.
The port keeps both, so that the collective record shows what the
reference's wire carries.

The stochastic rounding's noise, uniform in [-0.5, 0.5) a code, comes
from an explicit ``torch.Generator`` or from the caller: a list of noise
tensors, one a leaf in the tree's sorted-path order (the order of
``jax.tree.flatten`` on these dicts), so that a test can inject the
reference's draws. Top-k breaks ties toward the smaller flat index, as
``jax.lax.top_k`` (``core/topk.topk_stable``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.checkpoint.checkpointer import flatten_with_paths
from repro_torch.core.topk import topk_stable
from repro_torch.models.module import map_with_paths


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"       # none | int8 | topk
    topk_frac: float = 0.01
    seed: int = 0


def ef_init(params):
    """Error-feedback residual buffers, one per param (fp32), on each
    param's device."""
    return map_with_paths(
        lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device), params)


def _unflatten(paths: list[str], leaves: list, like):
    by_path = dict(zip(paths, leaves))
    return map_with_paths(lambda path, _: by_path[path], like)


def _noise(noise, i: int, g: torch.Tensor) -> torch.Tensor:
    """Leaf i's uniform [-0.5, 0.5) noise of g's shape."""
    if isinstance(noise, torch.Generator):
        u = torch.rand(g.shape, generator=noise, dtype=torch.float32,
                       device=noise.device)
        return (u - 0.5).to(g.device)
    return torch.as_tensor(noise[i], dtype=torch.float32).to(g.device)


def _quant_int8(g, noise):
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    scaled = g / scale
    q = torch.clamp(torch.round(scaled + noise), -127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q, scale):
    return q.to(torch.float32) * scale


def compress_grads(cfg: CompressionConfig, grads, ef,
                   noise: torch.Generator | Sequence[torch.Tensor] = None):
    """-> (payload, decompress_fn, new_ef). ``payload`` is what crosses
    the link: a list, one entry a leaf in sorted-path order ((int8 codes,
    fp32 scale) pairs for int8, dense fp32 carriers for top-k), or the
    grads themselves for "none"; ``decompress_fn(summed payload)`` gives
    dense fp32 grads in the grads' nesting. ``noise``: the int8 rounding's
    noise, a Generator or one tensor a leaf."""
    if cfg.kind == "none":
        return grads, (lambda x: x), ef

    items = flatten_with_paths(grads)
    paths = [p for p, _ in items]
    flat = [g for _, g in items]
    ef_flat = [e for _, e in flatten_with_paths(ef)]

    if cfg.kind == "int8":
        if noise is None:
            raise ValueError("int8 compression needs its noise: a "
                             "torch.Generator or one tensor a leaf")
        payload, new_ef = [], []
        for i, (g, e) in enumerate(zip(flat, ef_flat)):
            g32 = g.to(torch.float32) + e
            q, scale = _quant_int8(g32, _noise(noise, i, g32))
            new_ef.append(g32 - _dequant_int8(q, scale))
            payload.append((q, scale))

        def decompress(payload_summed):
            return _unflatten(paths, [_dequant_int8(q, s)
                                      for q, s in payload_summed], grads)

        return payload, decompress, _unflatten(paths, new_ef, grads)

    if cfg.kind == "topk":
        payload, new_ef = [], []
        for g, e in zip(flat, ef_flat):
            g32 = (g.to(torch.float32) + e).reshape(-1)
            k = max(1, int(cfg.topk_frac * g32.numel()))
            _, idx = topk_stable(torch.abs(g32), k)
            sparse_dense = torch.zeros_like(g32).index_put_(
                (idx,), g32[idx])
            new_ef.append((g32 - sparse_dense).reshape(g.shape))
            # a dense carrier; the wire format (ids + values) is not built
            payload.append(sparse_dense.reshape(g.shape))

        def decompress(payload_summed):
            return _unflatten(paths, list(payload_summed), grads)

        return payload, decompress, _unflatten(paths, new_ef, grads)

    raise ValueError(cfg.kind)


def compressed_psum(cfg: CompressionConfig, grads, ef, noise, axis_name: str,
                    *, mesh):
    """Compress -> sum over mesh axis ``axis_name`` -> decompress ->
    (summed dense fp32 grads, new_ef). int8: the codes are summed as int32
    and scaled by the mean scale (the sum of the scales over the sum of a
    ones scalar, the reference's ``psum(ones)``), the standard
    approximation whose mismatch the EF residual absorbs."""
    import torch.distributed as dist
    group = mesh.get_group(axis_name)

    def psum(t):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    payload, decompress, new_ef = compress_grads(cfg, grads, ef, noise)
    if cfg.kind == "none":
        return map_with_paths(lambda _, g: psum(g), payload), new_ef
    if cfg.kind == "int8":
        summed = []
        for q, s in payload:
            q32, s_sum = psum(q.to(torch.int32)), psum(s)
            n = psum(torch.ones((), dtype=torch.float32, device=s.device))
            summed.append((q32, s_sum / n))
        return decompress(summed), new_ef
    return decompress([psum(p) for p in payload]), new_ef
