"""Core layers of the LM and recsys families: linear, embedding, norms,
rotary, MLPs, recurrent cells.

Port of ``repro/models/layers.py:23-207``. An ``*_init`` draws a nested
dict of tensors from a ``torch.Generator`` on its device, with the
reference's distributions (its numbers differ: JAX's PRNG cannot be
reproduced); an ``*_apply`` takes that dict (or the ``nn.ParameterDict``
that ``models.module.as_module`` makes of it) and a tensor.

Types follow the reference: a dense layer on bf16 inputs gives a bf16
output (one bf16 matmul, accumulated in fp32: the package sets
``allow_bf16_reduced_precision_reduction = False``); the norms and rope
compute in fp32 and cast back; ``embedding_attend`` gives fp32 logits from
an fp32 matmul of the upcast inputs (the reference's
``preferred_element_type=jnp.float32``), never a bf16 matmul rounded to
bf16. The recurrent cells of the recsys family (``gru_cell``,
``augru_cell``, ``gru_scan``; reference ``:140-190``) follow the same
rules. ``segment_softmax`` (the graph edge softmax) and
``stable_bce_with_logits`` (the CTR train step's loss) are the
reference's ``:194-207``, term for term.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def _normal(gen: torch.Generator, shape, scale: float, dtype):
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


# ---------------------------------------------------------------- dense -----
def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, use_bias: bool = True,
               scale: float | None = None) -> dict:
    """kernel [d_in, d_out] ~ normal / sqrt(d_in) (the reference's layout),
    bias zeros."""
    scale = scale if scale is not None else 1.0 / (d_in ** 0.5)
    p = {"kernel": _normal(gen, (d_in, d_out), scale, dtype)}
    if use_bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense_apply(p, x):
    """x [..., d_in] @ kernel -> [..., d_out] in x's dtype (bf16 in, bf16
    out; fp32 stays fp32)."""
    w = p["kernel"]
    dt = torch.promote_types(x.dtype, w.dtype)
    y = torch.matmul(x.to(dt), w.to(dt))
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y.to(x.dtype)


# ------------------------------------------------------------- embedding ----
def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32, scale: float = 1.0) -> dict:
    return {"table": _normal(gen, (vocab, d), scale / (d ** 0.5), dtype)}


def embedding_apply(p, ids):
    return F.embedding(ids, p["table"])


def embedding_attend(p, x):
    """fp32 logits against the (possibly tied) table: x @ table^T."""
    return torch.matmul(x.to(torch.float32),
                        p["table"].to(torch.float32).t())


# ------------------------------------------------------------------ norms ---
def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> dict:
    """gemma-style: the weight is (1 + scale), scale starts at 0."""
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + p["scale"].to(torch.float32))
    return y.to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(p, x, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


# ----------------------------------------------------------------- rotary ---
def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding of the two halves of the head (not interleaved
    pairs), in fp32, cast back. x: [..., S, H, D]; positions: [..., S].
    On a DTensor ``x`` the frequencies are a replicated DTensor."""
    from repro_torch.models.module import replicated_like
    half = x.shape[-1] // 2
    exponent = -torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = replicated_like(torch.pow(torch.tensor(theta,
                                                   dtype=torch.float32),
                                      exponent / half), x)
    angles = positions[..., None].to(torch.float32) * freqs  # [.., S, half]
    angles = angles[..., None, :]                          # [.., S, 1, half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- MLPs ---
ACTS: dict[str, Callable] = {
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
    "tanh": torch.tanh,
}


def glu_mlp_init(gen: torch.Generator, d: int, d_ff: int,
                 dtype=torch.float32) -> dict:
    return {"gate": dense_init(gen, d, d_ff, dtype, use_bias=False),
            "up": dense_init(gen, d, d_ff, dtype, use_bias=False),
            "down": dense_init(gen, d_ff, d, dtype, use_bias=False)}


def glu_mlp_apply(p, x, act: str = "gelu"):
    g = ACTS[act](dense_apply(p["gate"], x))
    u = dense_apply(p["up"], x)
    return dense_apply(p["down"], g * u)


def mlp_init(gen: torch.Generator, dims: list[int], dtype=torch.float32,
             use_bias: bool = True) -> dict:
    """Plain MLP with len(dims)-1 layers: dims=[in, h1, ..., out]."""
    return {f"fc{i}": dense_init(gen, dims[i], dims[i + 1], dtype, use_bias)
            for i in range(len(dims) - 1)}


def mlp_apply(p, x, act: str = "relu", final_act: bool = False):
    n = len(p)
    for i in range(n):
        x = dense_apply(p[f"fc{i}"], x)
        if i < n - 1 or final_act:
            x = ACTS[act](x)
    return x


# --------------------------------------------------------- recurrent cells --
def gru_init(gen: torch.Generator, d_in: int, d_h: int,
             dtype=torch.float32) -> dict:
    return {"wx": dense_init(gen, d_in, 3 * d_h, dtype, use_bias=True),
            "wh": dense_init(gen, d_h, 3 * d_h, dtype, use_bias=False)}


def _gates(p, h, x):
    """The r, z and candidate n of a GRU step (gx and gh split r, z, n in
    that order)."""
    rx, zx, nx = dense_apply(p["wx"], x).chunk(3, dim=-1)
    rh, zh, nh = dense_apply(p["wh"], h).chunk(3, dim=-1)
    r = torch.sigmoid(rx + rh)
    z = torch.sigmoid(zx + zh)
    n = torch.tanh(nx + r * nh)
    return z, n


def gru_cell(p, h, x):
    """Standard GRU cell. h [B, H], x [B, D] -> h' = (1 - z)·n + z·h."""
    z, n = _gates(p, h, x)
    return (1 - z) * n + z * h


def augru_cell(p, h, x, att):
    """Attentional-update GRU (DIEN): the update gate scaled by the
    attention score att [B]; h' = (1 - z)·h + z·n (the other direction
    from :func:`gru_cell`)."""
    z, n = _gates(p, h, x)
    z = z * att[..., None]
    return (1 - z) * h + z * n


def gru_scan(p, xs, h0, cell=gru_cell, att=None):
    """Run a GRU over time: xs [B, T, D] (att [B, T] for an attentional
    cell) -> (outputs [B, T, H], final h). Each step projects its own input
    (no [B, T, 3H] projection of all steps) and writes its output into one
    [T, B, H] tensor, returned as its [B, T, H] view."""
    T = xs.shape[1]
    ys = torch.empty((T, *h0.shape), dtype=h0.dtype, device=h0.device)
    h = h0
    for t in range(T):
        h = cell(p, h, xs[:, t]) if att is None \
            else cell(p, h, xs[:, t], att[:, t])
        ys[t] = h
    return ys.transpose(0, 1), h


# ----------------------------------------------------------- segment ops ----
def segment_softmax(scores, segment_ids, num_segments: int):
    """Softmax over variable-size segments (edge softmax for graphs):
    scores [n], segment_ids [n] -> [n]. A segment's max is a
    ``scatter_reduce_("amax")`` from -inf (an empty segment keeps -inf,
    which becomes 0 as in the reference), its sum an ``index_add_``; the
    denominator carries the reference's + 1e-9."""
    seg = segment_ids.long()
    seg_max = torch.full((num_segments,), float("-inf"), dtype=scores.dtype,
                         device=scores.device)
    seg_max = seg_max.scatter_reduce(0, seg, scores, "amax")
    seg_max = torch.where(torch.isneginf(seg_max), 0.0, seg_max)
    ex = torch.exp(scores - seg_max[seg])
    seg_sum = torch.zeros((num_segments,), dtype=ex.dtype,
                          device=ex.device).index_add(0, seg, ex)
    return ex / (seg_sum[seg] + 1e-9)


def stable_bce_with_logits(logits, labels):
    """Numerically stable elementwise BCE from logits, in fp32:
    max(x, 0) - x·y + log1p(exp(-|x|)). At x = 0 the gradient is JAX's:
    ``torch.maximum`` splits it half each way as ``jnp.maximum`` does, and
    |x| is written so that its slope there is 1, as ``jnp.abs``'s (torch's
    ``abs`` has 0)."""
    x = logits.to(torch.float32)
    y = labels.to(torch.float32)
    ax = torch.where(x >= 0, x, -x)
    return (torch.maximum(x, torch.zeros_like(x)) - x * y
            + torch.log1p(torch.exp(-ax)))
