"""Plain PyTorch version of the causal flash-attention kernel.

A torch copy of the reference's oracle (``repro/kernels/flash_attn/ref.py``):
fp32 scores of the (upcast) inputs divided by sqrt(D), causal by absolute
position, softmax, the probabilities cast to v's dtype before the PV
product, which accumulates in fp32; the output has q's dtype. It also takes
GQA inputs, k and v with fewer heads than q: query head h reads KV head
h // (H / Hkv), as ``models/attention._sdpa`` groups them.
"""
from __future__ import annotations

import torch


def flash_attention_ref(q, k, v, *, q_chunk: int | None = None):
    """q [B, H, S, D], k, v [B, Hkv, S, D] -> o [B, H, S, D] (causal).

    ``q_chunk`` computes the queries that many at a time against the keys
    up to the chunk's last position, so that the score tensor is [B, H,
    q_chunk, S] at most, never [B, H, S, S]; each row's result is the same.
    """
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if H % Hkv:
        raise ValueError(f"flash_attention_ref: {H} query heads over {Hkv} "
                         f"KV heads")
    G = H // Hkv
    qc = S if q_chunk is None else q_chunk
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    pos = torch.arange(S, device=q.device)
    for s0 in range(0, S, qc):
        e = min(S, s0 + qc)
        qg = q[:, :, s0:e].to(torch.float32).reshape(B, Hkv, G, e - s0, D)
        s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf[:, :, :e]) / (D ** 0.5)
        mask = pos[s0:e, None] >= pos[None, :e]
        s = s.masked_fill(~mask, -torch.inf)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bksd->bkgqd",
                         p.to(v.dtype).to(torch.float32), vf[:, :, :e])
        out[:, :, s0:e] = o.reshape(B, H, e - s0, D).to(q.dtype)
    return out
