"""AdamW and Adafactor over parameter dicts, global-norm clipping and the
learning-rate schedules.

Port of ``repro/optim/optimizers.py``. Parameters, gradients and moments
are plain or nested dicts of tensors, as in the reference's pytrees.
``torch.optim.AdamW`` is not used: the reference's ``b2`` is 0.95, its
update is ``base - lr·(m̂/(√v̂ + eps) + wd·base)`` with the bias
corrections taken from a float32 step, and its state is ``{"step", "m",
"v"}``, which ``repro_torch.convert`` carries across both ways.

Adafactor keeps the reference's state layout: a leaf whose last two
dimensions are both at least ``min_dim_factored`` (128) has the factored
row and column moments ``{"vr", "vc"}``, any other leaf ``{"v"}``.

The updates run in place (parameters and moments are overwritten), so the
fit holds no second copy of the [R, H, B] weights or of their moments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.checkpoint.checkpointer import flatten_with_paths


# ---------------------------------------------------------------- schedules -
def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """lr(step) -> 0-d float32: linear warmup to ``base_lr`` over
    ``warmup`` steps, then a cosine decay to ``min_frac·base_lr`` at
    ``total``."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant_schedule(base_lr: float):
    return lambda step: torch.tensor(base_lr, dtype=torch.float32)


# ------------------------------------------------------------------- utils --
def global_norm_sq(tree: dict) -> torch.Tensor:
    """Sum of squares over every leaf of a (nested) dict, in fp32, leaves
    in sorted key order (the reference's pytree order)."""
    total = None
    for _, leaf in flatten_with_paths(tree):
        s = torch.sum(torch.square(leaf.float()))
        total = s if total is None else total + s
    return total


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(global_norm_sq(tree))


def apply_clip(grads: dict, norm, max_norm: float) -> dict:
    """Scale ``grads`` in place by min(1, max_norm / (norm + eps)) — the one
    copy of the clipping formula. Returns ``grads``."""
    scale = torch.clamp(max_norm / (torch.as_tensor(norm) + 1e-9), max=1.0)
    for _, g in flatten_with_paths(grads):
        g.mul_(scale.to(g.device, torch.float32).to(g.dtype))
    return grads


def clip_by_global_norm(grads: dict, max_norm: float):
    """-> (grads scaled in place to a global norm of at most ``max_norm``,
    the norm before the clip)."""
    norm = global_norm(grads)
    return apply_clip(grads, norm, max_norm), norm


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


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list:
    return [v for _, v in flatten_with_paths(tree)]


def adamw_init(cfg: AdamWConfig, params: dict) -> dict:
    """{"step": host int32 0, "m", "v": fp32 zeros in the params' nesting
    (a flat dict or nested dicts), "master": an fp32 copy when
    ``master_fp32``}."""
    zeros32 = lambda p: torch.zeros_like(p, dtype=torch.float32)
    state = {"step": torch.zeros((), dtype=torch.int32),   # host counter
             "m": _tree_map(zeros32, params),
             "v": _tree_map(zeros32, params)}
    if cfg.master_fp32:
        state["master"] = _tree_map(lambda p: p.detach().float().clone(),
                                    params)
    return state


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict):
    """One AdamW step, in place: ``params`` and the moments of ``state``
    are overwritten (``grads`` too, by the clip). ``params``, ``grads`` and
    the moments share one nesting (flat or nested dicts; leaves are
    walked in sorted key order). Returns (params, state, {"grad_norm",
    "lr"}), the reference's triple."""
    gnorm = global_norm(grads)
    if math.isfinite(cfg.clip_norm):        # inf: the fit clips it itself
        apply_clip(grads, gnorm, cfg.clip_norm)
    step = state["step"] + 1
    lr = _lr_at(cfg.lr, step)
    stepf = step.float()
    bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32) ** stepf
    bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32) ** stepf
    lr_f, bc1_f, bc2_f = float(lr), float(bc1), float(bc2)
    masters = _leaves(state["master"]) if cfg.master_fp32 else None
    for i, (p, g, m, v) in enumerate(zip(
            _leaves(params), _leaves(grads), _leaves(state["m"]),
            _leaves(state["v"]))):
        g32 = g.float()
        m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(g32).mul_(1 - cfg.b2))
        del g32
        base = masters[i] if cfg.master_fp32 else p.float()
        upd = torch.div(v, bc2_f).sqrt_().add_(cfg.eps)
        upd = torch.div(m, bc1_f).div_(upd)
        if cfg.weight_decay:
            upd.add_(base * cfg.weight_decay)
        base.sub_(upd.mul_(lr_f))
        del upd
        if base is not p:
            p.copy_(base)
    state["step"].copy_(step)                  # in place, as every leaf
    return params, state, {"grad_norm": gnorm, "lr": lr}


# --------------------------------------------------------------- Adafactor --
@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: Callable | float = 1e-2
    decay: float = 0.8          # second-moment decay exponent (t^-decay)
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    min_dim_factored: int = 128


def _factored(cfg: AdafactorConfig, p: torch.Tensor) -> bool:
    return p.ndim >= 2 and min(p.shape[-2:]) >= cfg.min_dim_factored


def adafactor_init(cfg: AdafactorConfig, params: dict) -> dict:
    """{"step": host int32 0, "v": params' nesting with each leaf replaced
    by {"vr" [..., rows], "vc" [..., cols]} (factored) or {"v"}}."""
    def leaf_state(p):
        if isinstance(p, dict):
            return {k: leaf_state(v) for k, v in p.items()}
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(cfg, p):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}
    return {"step": torch.zeros((), dtype=torch.int32),
            "v": leaf_state(params)}


@torch.no_grad()
def adafactor_update(cfg: AdafactorConfig, params: dict, grads: dict,
                     state: dict):
    """One Adafactor step, in place: ``params`` and the moments of
    ``state`` are overwritten. Returns (params, state, {"lr"}), the
    reference's triple."""
    step = state["step"] + 1
    t = step.float()
    beta2 = float(1.0 - t ** (-cfg.decay))
    lr = _lr_at(cfg.lr, step)
    lr_f = float(lr)

    def upd(p, g, s):
        g32 = g.float()
        g2 = torch.square(g32).add_(cfg.eps)
        if "vr" in s:
            vr, vc = s["vr"], s["vc"]
            vr.mul_(beta2).add_(torch.mean(g2, dim=-1) * (1 - beta2))
            vc.mul_(beta2).add_(torch.mean(g2, dim=-2) * (1 - beta2))
            denom = ((vr / torch.mean(vr, dim=-1, keepdim=True))[..., None]
                     * vc[..., None, :])
        else:
            denom = s["v"].mul_(beta2).add_(g2 * (1 - beta2))
        u = g32 * torch.rsqrt(denom + cfg.eps)
        # update clipping (RMS)
        rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
        u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
        new = p.float() - lr_f * u
        if cfg.weight_decay > 0:
            new = new - lr_f * cfg.weight_decay * p.float()
        p.copy_(new)

    def walk(p, g, s):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], g[k], s[k])
        else:
            upd(p, g, s)

    walk(params, grads, state["v"])
    state["step"].copy_(step)
    return params, state, {"lr": lr}


# --------------------------------------------------------------- interface --
@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    name: str


def make_optimizer(kind: str, **kw) -> Optimizer:
    """``make_optimizer("adamw" | "adafactor", **config)``."""
    if kind == "adamw":
        cfg = AdamWConfig(**kw)
        return Optimizer(lambda p: adamw_init(cfg, p),
                         lambda p, g, s: adamw_update(cfg, p, g, s), "adamw")
    if kind == "adafactor":
        cfg = AdafactorConfig(**kw)
        return Optimizer(lambda p: adafactor_init(cfg, p),
                         lambda p, g, s: adafactor_update(cfg, p, g, s),
                         "adafactor")
    raise ValueError(kind)
