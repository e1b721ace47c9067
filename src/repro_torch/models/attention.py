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
attention is outside any Pallas kernel too). The reference's sequence
sharding (``seq_shard``) is mesh machinery and is not ported.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import causal_attention
from repro_torch.models import layers as L
from repro_torch.models.module import grad_asked


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


def _qkv(p, cfg: AttnConfig, x, positions):
    """x [B, S, d] -> q [B, S, H, D], k, v [B, S, Kv, D]."""
    B, S, _ = x.shape
    q = L.dense_apply(p["q_proj"], x).reshape(B, S, cfg.n_heads,
                                              cfg.head_dim)
    k = L.dense_apply(p["k_proj"], x).reshape(B, S, cfg.n_kv_heads,
                                              cfg.head_dim)
    v = L.dense_apply(p["v_proj"], x).reshape(B, S, cfg.n_kv_heads,
                                              cfg.head_dim)
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


def attend_train(p, cfg: AttnConfig, x, positions=None):
    """Causal self-attention over [B, S, d_model]. positions [B, S]
    defaults to 0..S-1. Under a gradient each query chunk's ``_sdpa`` is
    recomputed in the backward (one chunk, S not a multiple of
    ``q_chunk`` or S <= q_chunk, is not checkpointed, as in the
    reference)."""
    B, S, _ = x.shape
    grad = grad_asked(x, p)
    kernel = uses_kernel(cfg, x.dtype, positions, grad)
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _qkv(p, cfg, x, positions)
    H, D = cfg.n_heads, cfg.head_dim

    if kernel:
        # [B, S, H, D] read in place as [B, H, S, D]; the output comes
        # back in the same layout, so the reshape is free
        out = causal_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2))
        out = out.transpose(1, 2).reshape(B, S, H * D)
        return L.dense_apply(p["o_proj"], out)

    qc = min(cfg.q_chunk, S)
    if S % qc != 0:
        qc = S

    def chunk(qi, pi, k, v):
        return _sdpa(qi, k, v, _mask(cfg.kind, pi, positions, cfg.window,
                                     cfg.chunk), cfg)

    outs = []
    for s0 in range(0, S, qc):
        args = (q[:, s0:s0 + qc], positions[:, s0:s0 + qc], k, v)
        outs.append(checkpoint(chunk, *args, use_reentrant=False)
                    if grad and qc < S else chunk(*args))
    return L.dense_apply(p["o_proj"], torch.cat(outs, dim=1))


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
