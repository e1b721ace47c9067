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
mesh=)``, ``build_lm_prefill`` and ``build_lm_decode`` on DTensors) the
positions and rope's frequencies are DTensors, and the attention runs on
each rank's block of heads (``_attend_mesh``): the kernel on the rank's
local q, k and v where ``uses_kernel`` holds (a prefill), the plain
chunks otherwise (every layer under a gradient); ``seq_shard`` (the
reference's opt-in context-parallel layout, ``attention.py:114-126``)
gives each rank a block of q's sequence against the whole k and v
instead, and turns the query chunking off; without a mesh only the latter
remains, as in the reference. ``attend_decode`` on DTensor caches
(``_decode_mesh``) writes and reads each rank's block of them in place:
its kv heads, or its block of the sequence, whose partial softmax sums
are merged across the ranks by the log-sum-exp rule.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import causal_attention
from repro_torch.models import layers as L
from repro_torch.models.module import (data_axes, grad_asked, is_dtensor,
                                       local_block, place, placements,
                                       reduce_over, replicated_like,
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


def _masked_scores(q, k, mask, cfg: AttnConfig):
    """fp32 scores [B, Kv, H / Kv, Sq, Sk] of q [B, Sq, H, D] against k
    [B, Sk, Kv, D] (the upcast inputs), soft-capped, the float32 minimum
    where mask [B or 1, Sq, Sk] is False."""
    B, Sq, H, D = q.shape
    Kv = k.shape[2]
    qg = q.reshape(B, Sq, Kv, H // Kv, D).to(torch.float32)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32))
    scores = scores / (D ** 0.5)
    if cfg.logit_cap > 0:
        scores = cfg.logit_cap * torch.tanh(scores / cfg.logit_cap)
    neg = torch.finfo(torch.float32).min
    return torch.where(mask[:, None, None, :, :], scores,
                       torch.full((), neg, device=scores.device))


def _sdpa(q, k, v, mask, cfg: AttnConfig):
    """q [B, Sq, H, D], k, v [B, Sk, Kv, D], mask [B or 1, Sq, Sk] ->
    [B, Sq, H*D]. fp32 scores of the upcast inputs, probabilities cast to
    v's dtype before an fp32-accumulated PV product."""
    B, Sq, H, D = q.shape
    probs = torch.softmax(_masked_scores(q, k, mask, cfg), dim=-1)
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


def _kv_heads_of(H: int, Kv: int, h0: int, H_l: int):
    """The kv heads that query heads h0 .. h0 + H_l - 1 read -> (the
    first, the count) when the kernel's GQA (query head i reads kv head
    i // (H_l / count)) reads them so from the distinct heads alone, else
    None."""
    g = H // Kv
    kv0, n = h0 // g, (h0 + H_l - 1) // g - h0 // g + 1
    if H_l % n or any((h0 + i) // g - kv0 != i // (H_l // n)
                      for i in range(H_l)):
        return None
    return kv0, n


def _attend_mesh(cfg: AttnConfig, q, k, v, positions, grad: bool,
                 kernel: bool = False):
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

    ``kernel`` (``uses_kernel`` held, positions 0..S-1, no ``seq_shard``):
    each rank's block goes to ``causal_attention`` (the flash-attention
    kernel on the card) with its distinct kv heads, read through the
    kernel's GQA where the query heads' groups allow, one copy a query
    head otherwise; ``positions`` is then not read.

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
    B_l, S_l, H_l = q_l.shape[:3]
    if heads and not kv_split and m > 1:
        h0 = mesh.get_local_rank("model") * H_l
        picked = _kv_heads_of(H, Kv, h0, H_l) if kernel else None
        if picked is None:          # one copy of its kv head a query head
            kv_idx = torch.arange(h0, h0 + H_l,
                                  device=q_l.device) // (H // Kv)
            k_l, v_l = k_l[:, :, kv_idx], v_l[:, :, kv_idx]
        else:
            k_l = k_l[:, :, picked[0]:picked[0] + picked[1]]
            v_l = v_l[:, :, picked[0]:picked[0] + picked[1]]
    if kernel:
        out = causal_attention(q_l.transpose(1, 2), k_l.transpose(1, 2),
                               v_l.transpose(1, 2))
        out = out.transpose(1, 2).reshape(B_l, S_l, H_l * cfg.head_dim)
    else:
        pos = positions.full_tensor() if is_dtensor(positions) \
            else positions
        q_pos = place(pos, q_spec[:2], mesh).to_local()
        k_pos = place(pos, (dp, None), mesh).to_local()
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
    each rank's block (``_attend_mesh``), through the kernel where
    ``uses_kernel`` holds and the sequence is whole on each rank."""
    B, S, _ = x.shape
    grad = grad_asked(x, p)
    kernel = uses_kernel(cfg, x.dtype, positions, grad)
    if positions is None:
        positions = replicated_like(
            torch.arange(S, device=x.device).expand(B, S), x)
    q, k, v = _qkv(p, cfg, x, positions)
    H, D = cfg.n_heads, cfg.head_dim

    if is_dtensor(q):
        out = _attend_mesh(cfg, q, k, v, positions, grad,
                           kernel and not cfg.seq_shard)
    elif kernel:
        # [B, S, H, D] read in place as [B, H, S, D]; the output comes
        # back in the same layout, so the reshape is free
        out = causal_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2))
        out = out.transpose(1, 2).reshape(B, S, H * D)
    else:
        out = _attend_chunks(cfg, q, k, v, positions, positions, grad)
    return L.dense_apply(p["o_proj"], out)


def _decode_mask(cfg: AttnConfig, positions, k_pos, Sc: int):
    """[B, 1, n] mask of the decode's query at positions [B, 1] against
    cache slots k_pos [1, n] (global slot indices) of a cache of Sc
    slots: the SWA ring's slot i holds absolute position pos - ((pos - i)
    mod Sc), masked while it is still empty; the other kinds' slot is the
    position."""
    if cfg.kind == "swa":
        abs_pos = positions - ((positions - k_pos) % Sc)
        return ((abs_pos >= 0) & (abs_pos <= positions))[:, None, :]
    B = positions.shape[0]
    return _mask(cfg.kind, positions, k_pos.expand(B, k_pos.shape[1]),
                 cfg.window, cfg.chunk)


def attend_decode(p, cfg: AttnConfig, x, cache_k, cache_v, pos):
    """One-step decode. x [B, 1, d_model]; cache_k, cache_v [B, Sc, Kv, D];
    pos [B] int (each row's absolute position).

    Writes the new K and V into slot pos (``full``, ``chunked``) or
    pos % Sc (``swa``: a ring buffer whose slot i holds absolute position
    pos - ((pos - i) mod Sc), masked while it is still empty) of the
    caches, in place, and returns (out [B, 1, d_model], cache_k,
    cache_v). DTensor caches are written and read on each rank's block
    (``_decode_mesh``)."""
    Sc = cache_k.shape[1]
    pos = pos.to(torch.int64)
    positions = pos.unsqueeze(1)                              # [B, 1]
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    if is_dtensor(cache_k):
        out = _decode_mesh(p, cfg, q, k_new, v_new, cache_k, cache_v, pos)
        return out, cache_k, cache_v
    rows = torch.arange(x.shape[0], device=x.device)
    slot = pos % Sc if cfg.kind == "swa" else pos
    mask = _decode_mask(cfg, positions,
                        torch.arange(Sc, device=x.device)[None, :], Sc)
    cache_k[rows, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v_new[:, 0].to(cache_v.dtype)
    out = _sdpa(q, cache_k, cache_v, mask, cfg)
    return L.dense_apply(p["o_proj"], out), cache_k, cache_v


def _decode_mesh(p, cfg: AttnConfig, q, k_new, v_new, cache_k, cache_v,
                 pos):
    """The decode's write, attention and o_proj on DTensor caches [B, Sc,
    Kv, D] (the registry's layouts: the batch over the data axes, or
    whole; the kv heads over "model", or the sequence over "model" or
    over ("data", "model")), each rank on its own block as local tensors
    (DTensor cannot carry an indexed write into a split dimension) ->
    DTensor [B, 1, d_model] (``_o_proj_block``).

    q, the new K and V and pos are laid out as the caches' batch and kv
    heads (each rank's query heads read its own kv heads). On a sequence
    split each rank holds ceil(Sc / n) slots from its block's start (the
    last blocks fewer): the rank whose block holds the slot writes it
    (a clamped index, the others writing back what they hold), scores its
    slots at their global indices, and the ranks' max, sums of
    exponentials and PV products (fp32) merge by the log-sum-exp rule: an
    all-reduce of the max over the axes that split the sequence, then of
    the sums and of the products (``_sdpa_merged``). No value is read by
    the host. The caches stay written in place."""
    from torch.distributed.tensor import Replicate
    mesh = cache_k.device_mesh
    cpl = list(cache_k.placements)
    dim = [getattr(p, "dim", None) for p in cpl]
    rows_pl = [p if d == 0 else Replicate() for p, d in zip(cpl, dim)]
    head_pl = [p if d in (0, 2) else Replicate() for p, d in zip(cpl, dim)]
    seq_dims = [i for i, d in enumerate(dim) if d == 1]
    q_l = q.redistribute(mesh, head_pl).to_local()        # [B_l, 1, H_l, D]
    k_l = k_new.redistribute(mesh, head_pl).to_local()[:, 0]
    v_l = v_new.redistribute(mesh, head_pl).to_local()[:, 0]
    pos_l = pos.redistribute(mesh, rows_pl).to_local()    # [B_l]
    ck, cv = cache_k.to_local(), cache_v.to_local()
    B, Sc = cache_k.shape[:2]
    (B_l, Sc_l, *_), (_, lo, *_) = local_block(cache_k.shape, mesh, cpl)
    rows = torch.arange(B_l, device=ck.device)
    slot = pos_l % Sc if cfg.kind == "swa" else pos_l
    if not seq_dims:
        ck[rows, slot] = k_l.to(ck.dtype)
        cv[rows, slot] = v_l.to(cv.dtype)
    elif Sc_l:
        at = slot - lo
        mine = ((at >= 0) & (at < Sc_l))[:, None, None]
        at = at.clamp(0, Sc_l - 1)
        ck[rows, at] = torch.where(mine, k_l.to(ck.dtype), ck[rows, at])
        cv[rows, at] = torch.where(mine, v_l.to(cv.dtype), cv[rows, at])
    k_pos = (lo + torch.arange(Sc_l, device=ck.device))[None, :]
    mask = _decode_mask(cfg, pos_l.unsqueeze(1), k_pos, Sc)
    if seq_dims:
        out = _sdpa_merged(q_l, ck, cv, mask, cfg, mesh, seq_dims)
    else:
        out = _sdpa(q_l, ck, cv, mask, cfg)
    return _o_proj_block(p["o_proj"], out, head_pl, mesh, B)


def _o_proj_block(p, out, out_pl, mesh, B: int):
    """o_proj of this rank's block out [B_l, 1, F_l] of the attention's
    output (its features laid out by ``out_pl``'s Shard(2), its rows by
    its Shard(0)) against the rank's block of the kernel [H*D, d], on
    local tensors -> DTensor [B, 1, d]: partial over the mesh dimensions
    that split the kernel's rows, split where its columns are. DTensor's
    own strategy for this matmul differs between torch versions where the
    rows are whole over "data" (long_500k's one row: 2.13 splits the
    kernel's columns over "data" and gathers them, 2.11 does not); here
    every version does the same."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    w = p["kernel"]
    HD, d = w.shape
    f0 = local_block((B, 1, HD), mesh, out_pl)[1][2]
    (n_r, _), (r0, _) = local_block(w.shape, mesh, w.placements)
    if r0 < f0 or r0 - f0 + n_r > out.shape[-1]:
        raise ValueError(f"o_proj's rows {r0}..{r0 + n_r} outside this "
                         f"rank's features {f0}..{f0 + out.shape[-1]}")
    y = L.dense_apply({"kernel": w.to_local()},
                      out[..., r0 - f0:r0 - f0 + n_r])
    pl = []
    for wp, op in zip(w.placements, out_pl):
        wd, od = getattr(wp, "dim", None), getattr(op, "dim", None)
        pl.append(Partial() if wd == 0 else Shard(2) if wd == 1
                  else Shard(0) if od == 0 else Replicate())
    return DTensor.from_local(y, mesh, pl, run_check=False,
                              shape=torch.Size((B, 1, d)),
                              stride=(d, d, 1))


def _sdpa_merged(q, k, v, mask, cfg: AttnConfig, mesh, dims):
    """``_sdpa`` of one query position q [B, 1, H, D] against this rank's
    block of the keys k, v [B, n, Kv, D] (mask [B, 1, n]), merged with the
    other blocks over the mesh dimensions ``dims`` -> [B, 1, H*D], in
    fp32: the scores' max all-reduced, then the sums of exponentials,
    then the PV products of the probabilities this rank's block holds
    (cast to v's dtype first, as ``_sdpa`` casts them): the meshless
    softmax's rounding, three small all-reduces a layer."""
    B, Sq, H, D = q.shape
    scores = _masked_scores(q, k, mask, cfg)
    top = scores.amax(-1, keepdim=True) if scores.shape[-1] else \
        torch.full(scores.shape[:-1] + (1,), torch.finfo(torch.float32).min,
                   device=scores.device)        # an empty block
    top = reduce_over(top, mesh, dims, "max")          # [B, Kv, g, Sq, 1]
    e = torch.exp(scores - top)
    total = reduce_over(e.sum(-1, keepdim=True), mesh, dims)
    probs = e / total
    out = torch.einsum("bkgqs,bskd->bqkgd",
                       probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))            # [B, Sq, Kv, g, D]
    out = reduce_over(out, mesh, dims)
    return out.to(q.dtype).reshape(B, Sq, H * D)


def decode_cache_len(cfg: AttnConfig, context_len: int) -> int:
    """Physical KV-cache length for a given logical context length."""
    if cfg.kind == "swa":
        return min(cfg.window, context_len)
    return context_len
