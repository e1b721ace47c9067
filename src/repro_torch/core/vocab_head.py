"""IRLI vocabulary-retrieval head for LMs.

A 256k-token softmax is an extreme-classification problem, IRLI's XML
scenario. The head keeps an IRLI partition over the vocabulary (labels =
token ids, label vectors = the output-embedding rows) and at serve time
computes logits only over the union of the top-m buckets of R reps:
O(m·R·V/B) candidate tokens instead of V.

Port of ``repro/core/vocab_head.py``: scorer -> top-m buckets -> member
gather -> candidate logits. The probe is the search's top-m stage: on the
card one ``irli_topk`` launch through ``core/query.scorer_top_m``, which
never allocates the [R, Bq, B] probabilities (their top-m is the logits'
top-m: softmax and sigmoid keep the order); on the CPU the plain stable
top-m of ``scorer_probs`` (``core/query.top_buckets``), what the reference
computes. The members are gathered in the reference's [Bq, R·m·max_load]
order (``core/query.gather_members``); a candidate's logit is its bf16 (or
fp32) table row against h, the products summed in fp32; a -1 pad gets
-inf.
"""
from __future__ import annotations

import torch

from repro_torch.core.partition import InvertedIndex
from repro_torch.core.query import gather_members, scorer_top_m, top_buckets
from repro_torch.kernels import on_card


def probe_buckets(scorer_params: dict, h: torch.Tensor, m: int,
                  loss_kind: str = "softmax_bce") -> torch.Tensor:
    """h [Bq, d] -> the top-m bucket ids of each rep [R, Bq, m]."""
    if on_card(h, scorer_params["w2"]):
        return scorer_top_m(scorer_params, h, m)[1]
    return top_buckets(scorer_params, h, m, loss_kind)[1]


def candidate_token_logits(scorer_params: dict, index: InvertedIndex,
                           embed_table: torch.Tensor, h: torch.Tensor, *,
                           m: int, loss_kind: str = "softmax_bce"):
    """h [Bq, d] final hidden states -> (cand_ids [Bq, C] int32, logits
    [Bq, C] fp32), C = R·m·max_load candidates (pad -1, logit -inf). The
    full [Bq, V] logits are never formed."""
    bidx = probe_buckets(scorer_params, h, m, loss_kind)       # [R, Bq, m]
    cands = gather_members(index.members, bidx)                # [Bq, C]
    valid = cands >= 0
    rows = embed_table[torch.where(valid, cands, 0).long()]    # [Bq, C, d]
    logits = torch.bmm(rows.to(torch.float32),
                       h.to(torch.float32)[:, :, None])[:, :, 0]
    return cands, logits.masked_fill_(~valid, float("-inf"))


def greedy_token(scorer_params: dict, index: InvertedIndex,
                 embed_table: torch.Tensor, h: torch.Tensor, *, m: int,
                 loss_kind: str = "softmax_bce") -> torch.Tensor:
    """The argmax over the candidate set only -> token ids [Bq] int32 (the
    first maximum, as ``jnp.argmax``; a duplicate candidate shares its
    logit, so duplicates change nothing)."""
    cands, logits = candidate_token_logits(scorer_params, index, embed_table,
                                           h, m=m, loss_kind=loss_kind)
    best = torch.argmax(logits, dim=1)
    return cands.gather(1, best[:, None])[:, 0]
