"""AdamW over the scorer's parameter dict, and global-norm clipping.

Port of ``repro/optim/optimizers.py`` (the parts the fit runs). Parameters,
gradients and moments are plain dicts of tensors, as in the reference's
pytrees. ``torch.optim.AdamW`` is not used: the reference's ``b2`` is 0.95,
its update is ``base - lr·(m̂/(√v̂ + eps) + wd·base)`` with the bias
corrections taken from a float32 step, and its state is ``{"step", "m",
"v"}``, which ``repro_torch.convert`` carries across both ways.

The update runs in place (parameters and moments are overwritten), so the
fit holds no second copy of the [R, H, B] weights or of their moments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


# ------------------------------------------------------------------- utils --
def global_norm_sq(tree: dict) -> torch.Tensor:
    """Sum of squares over every leaf, in fp32, leaves in sorted key order
    (the reference's pytree order)."""
    total = None
    for k in sorted(tree):
        s = torch.sum(torch.square(tree[k].float()))
        total = s if total is None else total + s
    return total


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(global_norm_sq(tree))


def apply_clip(grads: dict, norm, max_norm: float) -> dict:
    """Scale ``grads`` in place by min(1, max_norm / (norm + eps)) — the one
    copy of the clipping formula. Returns ``grads``."""
    scale = torch.clamp(max_norm / (torch.as_tensor(norm) + 1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.device, torch.float32).to(g.dtype))
    return grads


# ------------------------------------------------------------------- AdamW --
@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    master_fp32: bool = True   # keep fp32 master copy when params are bf16


def _lr_at(lr, step: torch.Tensor) -> torch.Tensor:
    out = lr(step) if callable(lr) else lr
    return torch.as_tensor(out, dtype=torch.float32)


def adamw_init(cfg: AdamWConfig, params: dict) -> dict:
    state = {"step": torch.zeros((), dtype=torch.int32),   # host counter
             "m": {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()},
             "v": {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()}}
    if cfg.master_fp32:
        state["master"] = {k: p.detach().float().clone()
                           for k, p in params.items()}
    return state


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict):
    """One AdamW step, in place: ``params`` and the moments of ``state``
    are overwritten (``grads`` too, by the clip). Returns (params, state,
    {"grad_norm", "lr"}), the reference's triple."""
    gnorm = global_norm(grads)
    if math.isfinite(cfg.clip_norm):        # inf: the fit clips it itself
        apply_clip(grads, gnorm, cfg.clip_norm)
    step = state["step"] + 1
    lr = _lr_at(cfg.lr, step)
    stepf = step.float()
    bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32) ** stepf
    bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32) ** stepf
    lr_f, bc1_f, bc2_f = float(lr), float(bc1), float(bc2)
    for k, p in params.items():
        g32 = grads[k].float()
        m, v = state["m"][k], state["v"][k]
        m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(g32).mul_(1 - cfg.b2))
        del g32
        base = state["master"][k] if cfg.master_fp32 else p.float()
        upd = torch.div(v, bc2_f).sqrt_().add_(cfg.eps)
        upd = torch.div(m, bc1_f).div_(upd)
        if cfg.weight_decay:
            upd.add_(base * cfg.weight_decay)
        base.sub_(upd.mul_(lr_f))
        del upd
        if base is not p:
            p.copy_(base)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


# --------------------------------------------------------------- interface --
@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    name: str


def make_optimizer(kind: str, **kw) -> Optimizer:
    """``make_optimizer("adamw", ...)``; the reference's other kinds are not
    on the fit's path and are not ported."""
    if kind == "adamw":
        cfg = AdamWConfig(**kw)
        return Optimizer(lambda p: adamw_init(cfg, p),
                         lambda p, g, s: adamw_update(cfg, p, g, s), "adamw")
    raise ValueError(f"optimizer {kind!r} is not ported")
