"""Grouped-query attention for the LM family.

Port of ``repro/models/attention.py:25-189``: MHA/GQA/MQA, RoPE / NoPE,
qk-norm (Qwen3), sliding-window (Mixtral), chunked-local (Llama-4), causal
full. ``attend_train`` is [B, S] self-attention. Its causal full case
(``kind="full"``, no logit cap, positions 0..S-1: what ``lm_backbone``
passes) is one launch of the flash-attention kernel on the card
(``kernels/flash_attention/ops.causal_attention``; the plain version on the
CPU), which holds no score tensor, when no gradient is asked. The other
kinds run ``_sdpa`` in plain torch, in query chunks, as in the reference,
and so do the cases the kernel does not take (float16, a head_dim that is
not a multiple of 16 in [16, 256]); the choice is made from the config,
the activation dtype and whether a gradient is asked (``uses_kernel``).
Under a gradient ``attend_train`` runs the reference's own training
algorithm (``attention.py:107-146``): the query-chunked ``_sdpa``, each
chunk recomputed in the backward (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint(body)``); the kernel has no backward, and the
reference's train path never calls its Pallas kernel either.
``attend_decode`` is one new token against a KV cache: the whole context
for ``full`` and ``chunked`` (masked by ``_mask`` at the absolute
positions), a ring buffer of ``min(window, context)`` slots for ``swa``
(write slot pos % Sc); it writes the new K and V into the caches it is
given, in place, and attends through ``_sdpa`` (the reference's decode
attention is outside any Pallas kernel too).

On a mesh (DTensor activations, ``launch/steps.build_lm_train_step(
mesh=)``) the positions and rope's frequencies are replicated DTensors,
and the attention runs on each rank's block of heads (``_attend_mesh``);
``seq_shard`` (the reference's opt-in context-parallel layout,
``attention.py:114-126``) gives each rank a block of q's sequence
against the whole k and v instead, and turns the query chunking off;
without a mesh only the latter remains, as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import causal_attention
from repro_torch.models import layers as L
from repro_torch.models.module import (data_axes, grad_asked, is_dtensor,
                                       place, placements, replicated_like,
                                       unshard_dim)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    kind: str = "full"          # full | swa | chunked
    window: int = 4096          # for swa
    chunk: int = 8192           # for chunked
    use_rope: bool = True       # False => NoPE (llama4 global layers)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    q_chunk: int = 1024         # query chunking of the plain path
    logit_cap: float = 0.0      # soft cap (0 = off)
    seq_shard: bool = False     # q's sequence over "model" on a mesh


def attn_init(gen: torch.Generator, cfg: AttnConfig,
              dtype=torch.float32) -> dict:
    d, H, Kv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"q_proj": L.dense_init(gen, d, H * D, dtype, use_bias=False),
         "k_proj": L.dense_init(gen, d, Kv * D, dtype, use_bias=False),
         "v_proj": L.dense_init(gen, d, Kv * D, dtype, use_bias=False),
         "o_proj": L.dense_init(gen, H * D, d, dtype, use_bias=False)}
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(D, dtype, gen.device)
        p["k_norm"] = L.rmsnorm_init(D, dtype, gen.device)
    return p


def _model_size(mesh) -> int:
    names = list(mesh.mesh_dim_names)
    return mesh.size(names.index("model")) if "model" in names else 1


def _heads(t, n: int, D: int):
    """[B, S, n·D] -> [B, S, n, D]. On a mesh whose "model" axis does not
    divide n the features are gathered whole first: DTensor will not
    unflatten a dimension split unevenly across heads."""
    if is_dtensor(t) and n % _model_size(t.device_mesh):
        t = unshard_dim(t, -1)
    B, S = t.shape[:2]
    return t.reshape(B, S, n, D)


def _qkv(p, cfg: AttnConfig, x, positions):
    """x [B, S, d] -> q [B, S, H, D], k, v [B, S, Kv, D]."""
    H, Kv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _heads(L.dense_apply(p["q_proj"], x), H, D)
    k = _heads(L.dense_apply(p["k_proj"], x), Kv, D)
    v = _heads(L.dense_apply(p["v_proj"], x), Kv, D)
    if cfg.qk_norm:
        q = L.rmsnorm_apply(p["q_norm"], q)
        k = L.rmsnorm_apply(p["k_norm"], k)
    if cfg.use_rope:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask(kind: str, q_pos, k_pos, window: int, chunk: int):
    """Boolean [.., Sq, Sk] mask: True = attend."""
    causal = q_pos[..., :, None] >= k_pos[..., None, :]
    if kind == "full":
        return causal
    if kind == "swa":
        near = q_pos[..., :, None] - k_pos[..., None, :] < window
        return causal & near
    if kind == "chunked":
        same_chunk = (torch.div(q_pos[..., :, None], chunk,
                                rounding_mode="floor")
                      == torch.div(k_pos[..., None, :], chunk,
                                   rounding_mode="floor"))
        return causal & same_chunk
    raise ValueError(kind)


def _sdpa(q, k, v, mask, cfg: AttnConfig):
    """q [B, Sq, H, D], k, v [B, Sk, Kv, D], mask [B or 1, Sq, Sk] ->
    [B, Sq, H*D]. fp32 scores of the upcast inputs, probabilities cast to
    v's dtype before an fp32-accumulated PV product."""
    B, Sq, H, D = q.shape
    Kv = k.shape[2]
    qg = q.reshape(B, Sq, Kv, H // Kv, D).to(torch.float32)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32))
    scores = scores / (D ** 0.5)
    if cfg.logit_cap > 0:
        scores = cfg.logit_cap * torch.tanh(scores / cfg.logit_cap)
    neg = torch.finfo(torch.float32).min
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full((), neg, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd",
                       probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32)).to(q.dtype)
    return out.reshape(B, Sq, H * D)


def uses_kernel(cfg: AttnConfig, dtype: torch.dtype, positions=None,
                grad: bool = False) -> bool:
    """Whether ``attend_train`` sends this config, at activation dtype
    ``dtype``, to the causal kernel: the function it computes (causal
    full attention, no logit cap, positions 0..S-1) on what it takes
    (float32 or bfloat16, head_dim a multiple of 16 in [16, 256]) when no
    gradient is asked (``grad``: ``models.module.grad_asked`` of the input
    and the layer's params), and nothing else. The kernel has no backward:
    its output, written through ctypes, carries no ``grad_fn``, so under a
    gradient it would cut the graph (and ``flash_attention`` refuses)."""
    return (not grad and cfg.kind == "full" and cfg.logit_cap == 0
            and positions is None
            and dtype in (torch.float32, torch.bfloat16)
            and cfg.head_dim % 16 == 0 and 16 <= cfg.head_dim <= 256)


def _attend_chunks(cfg: AttnConfig, q, k, v, q_pos, k_pos, grad: bool):
    """The plain attention of q [B, Sq, H, D] at positions q_pos [B, Sq]
    against k, v [B, Sk, Kv, D] at k_pos [B, Sk] -> [B, Sq, H*D], in query
    chunks of ``q_chunk`` (one chunk when Sq is not a multiple or with
    ``seq_shard``), each recomputed in the backward under a gradient."""
    Sq = q.shape[1]
    qc = min(cfg.q_chunk, Sq)
    if Sq % qc != 0 or cfg.seq_shard:
        qc = Sq     # seq-sharding bounds each rank's scores already

    def chunk(qi, pi, k, v):
        return _sdpa(qi, k, v, _mask(cfg.kind, pi, k_pos, cfg.window,
                                     cfg.chunk), cfg)

    outs = []
    for s0 in range(0, Sq, qc):
        args = (q[:, s0:s0 + qc], q_pos[:, s0:s0 + qc], k, v)
        outs.append(checkpoint(chunk, *args, use_reentrant=False)
                    if grad and qc < Sq else chunk(*args))
    return torch.cat(outs, dim=1)


def _attend_mesh(cfg: AttnConfig, q, k, v, positions, grad: bool):
    """``_attend_chunks`` of DTensor q, k, v [B, S, heads, D] on their
    mesh, each rank on its own block (DTensor cannot carry the grouped
    einsums of ``_sdpa`` over a sharded head dimension) -> DTensor [B, S,
    H*D]. The batch is split over the data axes, and over "model":

      * ``seq_shard``: q's sequence; k and v whole (the reference's
        context-parallel layout, ``attention.py:114-121``), the output's
        sequence gathered whole again for o_proj;
      * else the heads, when H divides by the axis: q's heads and, when
        Kv divides too, k's and v's (each rank's query heads then read
        its own kv heads), else k and v whole, each rank taking its
        query heads' kv heads;
      * else nothing (every rank computes every head).

    A k or v read whole by ranks that each use part of it gets its
    gradient as their sum (``to_local(grad_placements=Partial)``)."""
    from torch.distributed.tensor import DTensor, Partial
    mesh = q.device_mesh
    names = list(mesh.mesh_dim_names)
    dp = data_axes(mesh)
    m = _model_size(mesh)
    H, Kv = cfg.n_heads, cfg.n_kv_heads
    heads = not cfg.seq_shard and H % m == 0
    kv_split = heads and Kv % m == 0
    q_spec = ((dp, "model", None, None) if cfg.seq_shard else
              (dp, None, "model" if heads else None, None))
    kv_spec = (dp, None, "model" if kv_split else None, None)
    out_spec = ((dp, "model", None) if cfg.seq_shard else
                (dp, None, "model" if heads else None))
    kv_pl = placements(kv_spec, mesh)
    kv_grad = list(kv_pl)
    if m > 1 and (cfg.seq_shard or (heads and not kv_split)):
        kv_grad[names.index("model")] = Partial()
    q_l = q.redistribute(mesh, placements(q_spec, mesh)).to_local()
    k_l = k.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
    v_l = v.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
    pos = positions.full_tensor() if is_dtensor(positions) else positions
    q_pos = place(pos, q_spec[:2], mesh).to_local()
    k_pos = place(pos, (dp, None), mesh).to_local()
    if heads and not kv_split and m > 1:
        H_l = q_l.shape[2]
        h0 = mesh.get_local_rank("model") * H_l
        kv_idx = torch.arange(h0, h0 + H_l, device=q_l.device) // (H // Kv)
        k_l, v_l = k_l[:, :, kv_idx], v_l[:, :, kv_idx]
    out = _attend_chunks(cfg, q_l, k_l, v_l, q_pos, k_pos, grad)
    B, S = q.shape[:2]
    out = DTensor.from_local(out, mesh, placements(out_spec, mesh),
                             run_check=False,
                             shape=torch.Size((B, S, H * cfg.head_dim)),
                             stride=(S * H * cfg.head_dim,
                                     H * cfg.head_dim, 1))
    if cfg.seq_shard:
        # o_proj contracts the heads: the sequence is gathered whole
        # first (DTensor will not flatten a sharded sequence into rows)
        out = out.redistribute(mesh, placements((dp, None, None), mesh))
    return out


def attend_train(p, cfg: AttnConfig, x, positions=None):
    """Causal self-attention over [B, S, d_model]. positions [B, S]
    defaults to 0..S-1. Under a gradient each query chunk's ``_sdpa`` is
    recomputed in the backward (one chunk, S not a multiple of
    ``q_chunk``, S <= q_chunk or ``seq_shard``, is not checkpointed, as
    in the reference). On DTensors (a mesh) the attention itself runs on
    each rank's block (``_attend_mesh``)."""
    B, S, _ = x.shape
    grad = grad_asked(x, p)
    kernel = uses_kernel(cfg, x.dtype, positions, grad) and not is_dtensor(x)
    if positions is None:
        positions = replicated_like(
            torch.arange(S, device=x.device).expand(B, S), x)
    q, k, v = _qkv(p, cfg, x, positions)
    H, D = cfg.n_heads, cfg.head_dim

    if kernel:
        # [B, S, H, D] read in place as [B, H, S, D]; the output comes
        # back in the same layout, so the reshape is free
        out = causal_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2))
        out = out.transpose(1, 2).reshape(B, S, H * D)
        return L.dense_apply(p["o_proj"], out)

    if is_dtensor(q):
        out = _attend_mesh(cfg, q, k, v, positions, grad)
    else:
        out = _attend_chunks(cfg, q, k, v, positions, positions, grad)
    return L.dense_apply(p["o_proj"], out)


def attend_decode(p, cfg: AttnConfig, x, cache_k, cache_v, pos):
    """One-step decode. x [B, 1, d_model]; cache_k, cache_v [B, Sc, Kv, D];
    pos [B] int (each row's absolute position).

    Writes the new K and V into slot pos (``full``, ``chunked``) or
    pos % Sc (``swa``: a ring buffer whose slot i holds absolute position
    pos - ((pos - i) mod Sc), masked while it is still empty) of the
    caches, in place, and returns (out [B, 1, d_model], cache_k,
    cache_v)."""
    B = x.shape[0]
    Sc = cache_k.shape[1]
    pos = pos.to(torch.int64)
    positions = pos[:, None]                                   # [B, 1]
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    rows = torch.arange(B, device=x.device)
    k_pos = torch.arange(Sc, device=x.device)[None, :]        # [1, Sc]
    if cfg.kind == "swa":
        slot = pos % Sc
        abs_pos = positions - ((positions - k_pos) % Sc)
        mask = ((abs_pos >= 0) & (abs_pos <= positions))[:, None, :]
    else:
        slot = pos
        mask = _mask(cfg.kind, positions, k_pos.expand(B, Sc), cfg.window,
                     cfg.chunk)                                # [B, 1, Sc]
    cache_k[rows, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v_new[:, 0].to(cache_v.dtype)
    out = _sdpa(q, cache_k, cache_v, mask, cfg)
    return L.dense_apply(p["o_proj"], out), cache_k, cache_v


def decode_cache_len(cfg: AttnConfig, context_len: int) -> int:
    """Physical KV-cache length for a given logical context length."""
    if cfg.kind == "swa":
        return min(cfg.window, context_len)
    return context_len
