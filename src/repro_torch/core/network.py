"""The R stacked scorer networks f_r : R^d -> R^B.

Port of ``repro/core/network.py``: all R nets live in one stacked
parameter dict with leading axis R (``w1 [R,d,H]``, ``b1 [R,H]``,
``w2 [R,H,B]``, ``b2 [R,B]``) and run as one batched GEMM pair.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ScorerConfig:
    d_in: int
    d_hidden: int
    n_buckets: int       # B
    n_reps: int          # R
    loss: str = "softmax_bce"   # paper-faithful | "sigmoid_bce"
    param_dtype: str = "float32"


def scorer_init(cfg: ScorerConfig, generator: torch.Generator) -> dict:
    """Random scorer weights on ``generator.device``: normal weights scaled
    by 1/sqrt(fan-in), zero biases. The numbers differ from the reference's
    ``jax.random`` draw; carry those across with ``repro_torch.convert``."""
    dt = getattr(torch, cfg.param_dtype)
    dev = generator.device
    R, d, H, B = cfg.n_reps, cfg.d_in, cfg.d_hidden, cfg.n_buckets
    s1, s2 = 1.0 / d ** 0.5, 1.0 / H ** 0.5

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return w.mul_(scale).to(dt)

    return {
        "w1": normal((R, d, H), s1),
        "b1": torch.zeros((R, H), dtype=dt, device=dev),
        "w2": normal((R, H, B), s2),
        "b2": torch.zeros((R, B), dtype=dt, device=dev),
    }


def scorer_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [N, d] -> logits [R, N, B] fp32. One batched GEMM pair over all
    reps."""
    w1 = params["w1"]
    h = torch.matmul(x.to(w1.dtype), w1).float()                 # [R, N, H]
    h = torch.relu(h + params["b1"][:, None, :].float()).to(x.dtype)
    w2 = params["w2"]
    out = torch.bmm(h.to(w2.dtype), w2).float()                   # [R, N, B]
    return out + params["b2"][:, None, :].float()


def scorer_probs(params: dict, x: torch.Tensor,
                 loss_kind: str = "softmax_bce") -> torch.Tensor:
    """Bucket probability scores (softmax per paper, sigmoid variant)."""
    logits = scorer_logits(params, x)
    if loss_kind == "softmax_bce":
        return torch.softmax(logits, dim=-1)
    return torch.sigmoid(logits)
