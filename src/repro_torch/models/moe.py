"""Mixture-of-Experts block (GShard/Mixtral-style capacity dispatch) with an
optional IRLI-flavoured router.

Port of ``repro/models/moe.py``. Routing modes:
  - ``topk``         — softmax top-k with the GShard load-balance loss;
  - ``irli_kchoice`` — the paper's power-of-K-choices applied to experts:
    each token considers its top-K experts and takes, for each of its
    ``top_k`` slots, the least-loaded one it has not taken yet, tokens in
    order (aux-loss-free balance). On the card that walk is one launch of
    the ``kchoice`` kernel (``kernels/kchoice``: G = 1 for the flat token
    block, G = batch rows in the per-row path, ``slots = top_k``); on the
    CPU its plain version. No Python loop over tokens runs on the card.

Both routers take their top-K with ``core/topk.topk_stable``: a tie goes to
the smaller expert id, as ``jax.lax.top_k`` breaks it. Dispatch is the
reference's capacity-bounded scatter into [E, C, d] (``_moe_tokens``) or
[B, E, C, d] (``_moe_rows``, the path of a block longer than
``ffn_chunk``), a token's queue position the running count of its expert
over the (token, slot) pairs in order; the expert products are batched
matmuls over the stacked [E, d, f] weights (the reference computes them in
plain XLA, outside any Pallas kernel). ``_moe_tokens`` accumulates them in
fp32 and returns fp32 before the casts the reference makes; ``_moe_rows``
keeps the activation dtype, as the reference's. The top-k outputs of a
token are summed in slot order in the activation dtype. The reference's
mesh constraints (``constrain_first``) do nothing on one device and are
not ported.

On a mesh (DTensor activations and expert stacks, ``launch/steps.
build_lm_train_step(mesh=)``) the routing, the capacity scatter into the
dispatch buffer and the combine run on local tensors (DTensor carries
neither the boolean row writes of ``topk_stable`` nor the accumulating
``index_put_``, and the ``kchoice`` kernel takes the local tensors, never
a DTensor's pointer): ``_moe_tokens``' flat block, whose queues run over
every token, on the whole block on every rank (``models.module.
on_whole``); ``_moe_rows``' row-local work on each data rank's own rows
(``models.module.on_rows``), so its [B, E, C, d] buffer is split over
the data axes as the reference pins it. The expert products run on the
DTensors, sharded as the stacks are (tensor-parallel over d_ff, or
experts over "model").

Under a gradient the router's gates and the aux loss are differentiable
torch ops; the dispatch indices are not (``kchoice`` returns ints, as the
reference's scan does), and a recompute (``lm_backbone``'s remat) routes
exactly as its forward: both routers are deterministic functions of the
logits.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core.topk import topk_stable
from repro_torch.kernels.kchoice.ops import kchoice_assign
from repro_torch.models import layers as L
from repro_torch.models.module import (data_axes, is_dtensor, on_rows,
                                       on_whole, pin_batch)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    router: str = "topk"          # topk | irli_kchoice
    router_k_choices: int = 4      # K for irli_kchoice (>= top_k)
    n_shared_experts: int = 0      # llama4-style always-on shared expert
    act: str = "silu"
    ffn_chunk: int = 65536         # max tokens dispatched at once (memory cap)


def _expert_stack(gen: torch.Generator, E: int, shape, scale: float,
                  dtype) -> torch.Tensor:
    """[E, *shape] ~ normal · scale in dtype, drawn an expert at a time:
    the fp32 draw never holds more than one expert (llama4's stacks are
    10.7 GB each in bf16, 21.5 GB in fp32)."""
    out = torch.empty((E, *shape), dtype=dtype, device=gen.device)
    if is_fake(out):        # shapes only (``configs/base.abstract``)
        return out
    for e in range(E):
        out[e] = L._normal(gen, shape, scale, dtype)
    return out


def moe_init(gen: torch.Generator, cfg: MoEConfig,
             dtype=torch.float32) -> dict:
    """router kernel [d, E]; experts gate, up [E, d, f] ~ normal / sqrt(d)
    and down [E, f, d] ~ normal / sqrt(f), one stacked tensor each; a
    shared GLU expert of width f·n_shared_experts where there is one."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": L.dense_init(gen, d, E, dtype, use_bias=False),
         "experts": {"gate": _expert_stack(gen, E, (d, f), d ** -0.5, dtype),
                     "up": _expert_stack(gen, E, (d, f), d ** -0.5, dtype),
                     "down": _expert_stack(gen, E, (f, d), f ** -0.5,
                                           dtype)}}
    if cfg.n_shared_experts > 0:
        p["shared"] = L.glu_mlp_init(gen, d, f * cfg.n_shared_experts, dtype)
    return p


def _capacity(cfg: MoEConfig, n_tokens: int) -> int:
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, ((cap + 7) // 8) * 8)  # a multiple of 8, as the reference


def _route_topk(logits, cfg: MoEConfig):
    """Standard top-k routing. logits [.., T, E] -> (weights [.., T, k] f32,
    idx [.., T, k] int64, aux [..]: E · sum_e(frac_tokens_e · mean_prob_e)
    over the T tokens)."""
    E = logits.shape[-1]
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    w, idx = topk_stable(probs, cfg.top_k)
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    me = probs.mean(-2)
    ce = F.one_hot(idx[..., 0], E).to(torch.float32).mean(-2)
    return w, idx, E * (me * ce).sum(-1)


def _route_irli_kchoice(logits, cfg: MoEConfig):
    """Power-of-K-choices routing (the paper's Thm. 2 applied to experts):
    tokens in order, each of a token's ``top_k`` slots the least-loaded of
    its top ``max(router_k_choices, top_k)`` experts it has not taken yet
    (the first in choice order at equal load), each pick adding 1 to its
    expert's load; every row of a [G, T, E] input has its own loads.
    logits [.., T, E] -> (weights [.., T, k] f32, idx [.., T, k] int64,
    aux 0)."""
    E = logits.shape[-1]
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    K = max(cfg.router_k_choices, cfg.top_k)
    _, topi = topk_stable(probs, K)                          # [.., T, K]
    ti = topi.reshape(-1, *topi.shape[-2:])                  # [G, T, K]
    G, T = ti.shape[:2]
    order = torch.arange(T, dtype=torch.int32,
                         device=ti.device).expand(G, T)
    idx = kchoice_assign(ti.to(torch.int32), order, B=E, slots=cfg.top_k)
    idx = idx.reshape(*topi.shape[:-1], cfg.top_k).long()
    w = probs.gather(-1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    return w, idx, torch.zeros((), dtype=torch.float32, device=w.device)


def _route(logits, cfg: MoEConfig):
    if cfg.router == "irli_kchoice":
        return _route_irli_kchoice(logits, cfg)
    if cfg.router == "topk":
        return _route_topk(logits, cfg)
    raise ValueError(f"unknown router {cfg.router!r}")


def _queue_positions(idx, E: int, C: int):
    """Each (token, slot)'s place in its expert's queue, the (token, slot)
    pairs taken in order: idx [.., T, k] -> (pos [.., T, k] int64, keep:
    pos < C)."""
    *lead, T, k = idx.shape
    flat = F.one_hot(idx, E).reshape(*lead, T * k, E)
    pos = (torch.cumsum(flat, dim=-2) * flat - 1).amax(-1).reshape(idx.shape)
    return pos, (pos < C) & (pos >= 0)


class _BmmF32Out(torch.autograd.Function):
    """bf16 a @ b with an fp32 output (``torch.bmm(..., out_dtype=
    torch.float32)``), differentiable: ``aten::bmm.dtype`` has no
    derivative in torch 2.11 (probed on the card: "derivative for
    aten::bmm is not implemented"). The backward makes the same bf16
    products with an fp32 output, g·bᵀ and aᵀ·g (the incoming fp32
    gradient rounded to bf16 first), each cast to its input's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.transpose(1, 2),
                           out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.transpose(1, 2), g,
                           out_dtype=torch.float32).to(b.dtype)
        return ga, gb


def _f32_bmm(a, b):
    """a [n, i, j] @ b [n, j, l], products summed in fp32 -> fp32: bf16
    operands on the card go to one bf16 matmul with an fp32 output
    (``_BmmF32Out``, which carries its own backward); on the CPU, on
    DTensors (DTensor has no rule for ``bmm`` with ``out_dtype``) or with
    fp32 operands an fp32 matmul of the upcast operands."""
    from repro_torch.kernels import on_card
    if not is_dtensor(a) and a.dtype == b.dtype \
            and a.dtype != torch.float32 and on_card(a):
        return _BmmF32Out.apply(a, b)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def _experts_f32(p, cfg: MoEConfig, disp, dtype):
    """The stacked GLU experts on disp [E, C, d], accumulated in fp32:
    (act(disp·gate) · (disp·up)) in fp32, cast to dtype, then ·down in
    fp32, cast to dtype -> [E, C, d]."""
    ex = p["experts"]
    h = _f32_bmm(disp, ex["gate"])
    u = _f32_bmm(disp, ex["up"])
    h = (L.ACTS[cfg.act](h) * u).to(dtype)
    return _f32_bmm(h, ex["down"]).to(dtype)


def _dispatch_tokens(cfg: MoEConfig, logits, xt):
    """Routing and the capacity scatter of a flat token block: router
    logits [T, E], xt [T, d] -> (disp [E, C, d], w [T, k] (0 where
    dropped), idx [T, k], pos [T, k] clamped to the capacity, keep
    [T, k], aux)."""
    T, d = xt.shape
    k, E = cfg.top_k, cfg.n_experts
    w, idx, aux = _route(logits, cfg)                          # [T, k]
    C = _capacity(cfg, T)
    pos, keep = _queue_positions(idx, E, C)
    w = torch.where(keep, w, 0.0)
    pos = pos.clamp(0, C - 1)
    tok_flat = torch.arange(T, device=xt.device).repeat_interleave(k)
    keep_flat = keep.reshape(-1)
    vals = torch.where(keep_flat[:, None], xt[tok_flat], 0.0)
    disp = torch.zeros((E, C, d), dtype=xt.dtype, device=xt.device)
    disp.index_put_((idx.reshape(-1), pos.reshape(-1)), vals,
                    accumulate=True)
    return disp, w, idx, pos, keep, aux


def _combine_tokens(out_e, w, idx, pos, keep):
    """The experts' outputs out_e [E, C, d] back to their tokens, weighted
    and summed over a token's k slots in slot order -> y [T, d]."""
    T, k = idx.shape
    keep_flat = keep.reshape(-1)
    gathered = out_e[idx.reshape(-1), pos.reshape(-1)] * (
        w.reshape(-1, 1) * keep_flat[:, None]).to(out_e.dtype)
    # the reference's segment_sum over a token's k slots, in slot order
    gathered = gathered.reshape(T, k, -1)
    y = torch.zeros_like(gathered[:, 0])
    for j in range(k):
        y = y + gathered[:, j]
    return y


def _moe_tokens(p, cfg: MoEConfig, xt):
    """Dispatch + expert compute + combine for a flat token block [T, d]
    -> (y [T, d], aux)."""
    disp, w, idx, pos, keep, aux = on_whole(
        functools.partial(_dispatch_tokens, cfg),
        L.dense_apply(p["router"], xt), xt)
    out_e = _experts_f32(p, cfg, disp, xt.dtype)               # [E, C, d]
    y = pin_batch(on_whole(_combine_tokens, out_e, w, idx, pos, keep))
    if cfg.n_shared_experts > 0:
        y = y + pin_batch(L.glu_mlp_apply(p["shared"], xt, cfg.act))
    return y, aux


def _dispatch_rows(cfg: MoEConfig, logits, x):
    """Row-local routing and capacity scatter: logits [B, T, E], x [B, T,
    d] -> (disp [B, E, C, d], w, idx, pos (clamped), keep [B, T, k], aux
    [B] of each row)."""
    B, T, d = x.shape
    k, E = cfg.top_k, cfg.n_experts
    w, idx, aux = _route(logits, cfg)                          # [B, T, k]
    aux = aux.expand(B).contiguous()
    C = _capacity(cfg, T)
    pos, keep = _queue_positions(idx, E, C)
    w = torch.where(keep, w, 0.0)
    pos = pos.clamp(0, C - 1)
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, T)
    disp = torch.zeros((B, E, C, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        v_j = torch.where(keep[:, :, j, None], x, 0.0)
        disp.index_put_((b_idx, idx[:, :, j], pos[:, :, j]), v_j,
                        accumulate=True)
    return disp, w, idx, pos, keep, aux


def _combine_rows(out_e, w, idx, pos, keep):
    """out_e [B, E, C, d] back to the rows' tokens -> y [B, T, d]."""
    B, T, k = idx.shape
    b_idx = torch.arange(B, device=out_e.device)[:, None].expand(B, T)
    y = torch.zeros((B, T, out_e.shape[-1]), dtype=out_e.dtype,
                    device=out_e.device)
    for j in range(k):
        o_j = out_e[b_idx, idx[:, :, j], pos[:, :, j]]
        y = y + o_j * (w[:, :, j, None] * keep[:, :, j, None]).to(
            out_e.dtype)
    return y


def _experts_over_rows_axis(ex) -> bool:
    """Whether the stacked experts are split over "model" and their
    feature dimension over "data" (2-D expert x tensor parallelism,
    ``configs/lm_common.lm_rules`` at 16 experts or more): the axis that
    also splits the rows."""
    from torch.distributed.tensor import Shard
    g = ex["gate"]
    if not is_dtensor(g):
        return False
    pl = dict(zip(g.device_mesh.mesh_dim_names, g.placements))
    return pl.get("model") == Shard(0) and pl.get("data") == Shard(2)


def _experts_weight_local(ex, act, disp, dtype):
    """The expert GLU on a mesh with the contractions weight-local (the
    rules' intent): disp [B, E, C, d] (rows over the data axes) gathered
    over "data" only, each rank applies its own experts (over "model")
    and its slice of the feature dimension (over "data") to its data
    group's rows, and the fp32 partial sums of the down projection are
    reduce-scattered over "data" back to the rows -> [B, E, C, d] in
    ``dtype``, the experts over "model". The weights never move; the
    rows cross "data" twice. (DTensor's own rule for these products
    gathers the weights over "data" and views a rank's permuted block,
    which two or more rows cannot be.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = disp.device_mesh
    names = list(mesh.mesh_dim_names)
    dax = data_axes(mesh)
    rows = disp.redistribute(mesh, [
        Replicate() if n in ("data", "model") else p
        for n, p in zip(names, disp.placements)])
    part = [Partial() if n in ("data", "model") else p
            for n, p in zip(names, rows.placements)]
    x = rows.to_local(grad_placements=part)

    def local(w):
        return w.to_local(grad_placements=[
            Partial() if n in dax and isinstance(p, Replicate) else p
            for n, p in zip(names, w.placements)])

    g, u, dn = local(ex["gate"]), local(ex["up"]), local(ex["down"])
    e_loc = g.shape[0]
    e0 = mesh.get_local_rank("model") * e_loc
    x = x[:, e0:e0 + e_loc]                        # this rank's experts
    h = torch.einsum("becd,edf->becf", x, g)
    h = (L.ACTS[act](h) * torch.einsum("becd,edf->becf", x, u)).to(dtype)
    B, E, C, F = h.shape
    o = _f32_bmm(h.permute(1, 0, 2, 3).reshape(E, B * C, F), dn)
    o = o.reshape(E, B, C, -1).permute(1, 0, 2, 3).contiguous()
    out = DTensor.from_local(o, mesh, [
        Partial() if n == "data" else Shard(1) if n == "model" else p
        for n, p in zip(names, rows.placements)], run_check=False,
        shape=(disp.shape[0], disp.shape[1], C, o.shape[-1]),
        stride=(disp.shape[1] * C * o.shape[-1], C * o.shape[-1],
                o.shape[-1], 1))
    return out.redistribute(mesh, [
        Shard(1) if n == "model" else p
        for n, p in zip(names, disp.placements)]).to(dtype)


def _moe_rows(p, cfg: MoEConfig, x):
    """Per-batch-row capacity dispatch. x [B, T, d] -> (y [B, T, d], aux):
    routing (each row its own loads), queue positions, the [B, E, C_row, d]
    dispatch and the combine are row-local; the expert products keep the
    activation dtype. On a mesh each data rank does its own rows'
    (``on_rows``)."""
    disp, w, idx, pos, keep, aux = on_rows(
        functools.partial(_dispatch_rows, cfg),
        L.dense_apply(p["router"], x), x)
    ex = p["experts"]
    if _experts_over_rows_axis(ex):
        out_e = _experts_weight_local(ex, cfg.act, disp, x.dtype)
    else:
        h = torch.einsum("becd,edf->becf", disp, ex["gate"])
        u = torch.einsum("becd,edf->becf", disp, ex["up"])
        h = (L.ACTS[cfg.act](h) * u).to(x.dtype)
        out_e = torch.einsum("becf,efd->becd", h, ex["down"]).to(x.dtype)
    y = on_rows(_combine_rows, out_e, w, idx, pos, keep)
    if cfg.n_shared_experts > 0:
        y = y + pin_batch(L.glu_mlp_apply(p["shared"], x, cfg.act))
    return y, aux.mean()


def moe_apply(p, cfg: MoEConfig, x):
    """x [B, S, d] -> (y [B, S, d], aux loss). Capacity-bounded dispatch.

    When T = B·S exceeds ``ffn_chunk`` (and the sequence splits evenly),
    the tokens go through ``_moe_rows`` in sequence chunks of
    ffn_chunk // B, one after another (the FFN is position-independent):
    the dispatch buffers stay bounded at prefill scale. Otherwise the
    whole block is one ``_moe_tokens`` call."""
    B, S, d = x.shape
    T = B * S
    s_chunk = max(1, cfg.ffn_chunk // max(B, 1))
    if T > cfg.ffn_chunk and S % s_chunk == 0 and S // s_chunk > 1:
        ys, auxs = [], []
        for s0 in range(0, S, s_chunk):
            y, aux = _moe_rows(p, cfg, x[:, s0:s0 + s_chunk])
            ys.append(y)
            auxs.append(aux)
        return torch.cat(ys, dim=1), torch.stack(auxs).sum()
    y, aux = _moe_tokens(p, cfg, x.reshape(T, d))
    return y.reshape(B, S, d), aux
