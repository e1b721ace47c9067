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


def scorer_hidden(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [N, d] -> the first layer's activations relu(x @ w1 + b1)
    [R, N, H], summed in fp32 and returned in x's dtype. The query path
    feeds them to the fused output layer + top-m (kernels/irli_topk)."""
    w1 = params["w1"]
    h = torch.matmul(x.to(w1.dtype), w1).float()                 # [R, N, H]
    # in place: neither op's backward needs what it overwrites, and the
    # fit's affinity chunk (65536 rows) would otherwise hold three copies
    h.add_(params["b1"][:, None, :].float()).relu_()
    return h.to(x.dtype)


def scorer_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [N, d] -> logits [R, N, B] fp32. One batched GEMM pair over all
    reps."""
    h = scorer_hidden(params, x)
    w2 = params["w2"]
    out = torch.bmm(h.to(w2.dtype), w2).float()                   # [R, N, B]
    return out.add_(params["b2"][:, None, :].float())


def scorer_probs(params: dict, x: torch.Tensor,
                 loss_kind: str = "softmax_bce") -> torch.Tensor:
    """Bucket probability scores (softmax per paper, sigmoid variant)."""
    logits = scorer_logits(params, x)
    if loss_kind == "softmax_bce":
        return torch.softmax(logits, dim=-1)
    return torch.sigmoid(logits)


def scorer_loss_parts(params: dict, cfg: ScorerConfig, x: torch.Tensor,
                      targets: torch.Tensor, weights=None, *,
                      scale: float = 1.0):
    """Weighted-sum decomposition of the BCE loss -> ``(scale · sum,
    wsum)``: ``sum = Σ_r Σ_n w_n · rowloss(r, n)``, ``wsum = Σ_n w_n``
    (``weights`` default to ones). The fit divides by ``R · max(wsum, 1)``;
    it passes that as ``scale``, which the sigmoid kernel folds into its one
    pass, so zero-weight padding rows recover the unweighted mean.

    ``softmax_bce`` (the paper's) is plain torch, differentiated by
    autograd. ``sigmoid_bce`` goes through the ``bce_logits`` kernel on the
    card (its plain version on the CPU), whose backward is the gradient the
    forward pass wrote."""
    from repro_torch.kernels.bce_logits.ops import sigmoid_bce_loss
    logits = scorer_logits(params, x)                          # [R, N, B]
    N = logits.shape[1]
    if weights is None:
        weights = torch.ones((N,), dtype=torch.float32, device=x.device)
    weights = weights.to(torch.float32)
    if cfg.loss == "softmax_bce":
        logp = torch.log_softmax(logits, dim=-1)
        p = torch.exp(logp)
        # -[y log p + (1-y) log(1-p)], stable via log1p(-p) clamp
        log1mp = torch.log1p(-torch.clamp(p, 0.0, 1.0 - 1e-6))
        per = -(targets * logp + (1.0 - targets) * log1mp)
        row = torch.sum(per, dim=-1)                           # [R, N]
        s = torch.sum(row * weights[None, :])
        if scale != 1.0:
            s = s * scale
    elif cfg.loss == "sigmoid_bce":
        s = sigmoid_bce_loss(logits, targets, weights, scale=scale)
    else:
        raise ValueError(f"unknown loss {cfg.loss!r}")
    return s, torch.sum(weights)


def scorer_loss(params: dict, cfg: ScorerConfig, x: torch.Tensor,
                targets: torch.Tensor, weights=None) -> torch.Tensor:
    """BCE against multi-hot bucket targets [R, N, B]: the weighted mean
    over rows and reps (zero-weight rows are ignored)."""
    s, wsum = scorer_loss_parts(params, cfg, x, targets, weights)
    R = params["w1"].shape[0]
    return s / (R * torch.clamp(wsum, min=1.0))
