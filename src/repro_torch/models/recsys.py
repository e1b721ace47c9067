"""RecSys architectures: DIEN (AUGRU interest evolution).

Port of ``repro/models/recsys.py:67-123`` for the forward. The params are
the reference's tree (``item_emb``, ``cate_emb``, ``gru1``, ``augru``,
``att``, ``top``) as an ``nn.ModuleDict`` (``models.module.as_module``);
``convert.dien_params_from_reference`` carries the reference's weights
across. The forward follows the reference line by line, except that the
history sum (``recsys.py:120``: the history rows weighted by the mask) is
``bag_lookup_reduce`` over the item and the category table: the
embedding_bag kernel on the card, two launches a forward. DLRM, BST and
xDeepFM wait (ROADMAP).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import resolve_device
from repro_torch.kernels.embedding_bag.ops import bag_lookup_reduce
from repro_torch.models import embedding as E
from repro_torch.models import layers as L
from repro_torch.models.module import as_module


@dataclasses.dataclass(frozen=True)
class DIENConfig:
    name: str = "dien"
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp: tuple[int, ...] = (200, 80)
    item_vocab: int = 1_000_000
    cate_vocab: int = 100_000
    param_dtype: str = "float32"


def dien_init(cfg: DIENConfig, *, seed: int = 0,
              device: str | torch.device = "cuda") -> torch.nn.ModuleDict:
    """Random weights on ``device`` from a ``torch.Generator`` seeded
    ``seed``, with the reference's distributions (tables normal · 0.01,
    dense kernels normal / sqrt(d_in), biases 0; not its numbers)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    d2 = cfg.embed_dim * 2  # item + category embedding concat
    return as_module({
        "item_emb": E.bag_init(gen, cfg.item_vocab, cfg.embed_dim, dt),
        "cate_emb": E.bag_init(gen, cfg.cate_vocab, cfg.embed_dim, dt),
        "gru1": L.gru_init(gen, d2, cfg.gru_dim, dt),
        "augru": L.gru_init(gen, cfg.gru_dim, cfg.gru_dim, dt),
        "att": L.mlp_init(gen, [cfg.gru_dim + d2, 80, 40, 1], dt),
        "top": L.mlp_init(gen, [cfg.gru_dim + d2 * 2, *cfg.mlp, 1], dt),
    })


def dien_apply(p, cfg: DIENConfig, hist_items, hist_cates, target_item,
               target_cate, hist_mask):
    """hist_* [B, T] int; target_* [B] int; hist_mask [B, T] -> logit [B].
    A row whose mask is all 0 attends uniformly, as in the reference."""
    B, T = hist_items.shape
    he = torch.cat([E.bag_lookup(p["item_emb"], hist_items),
                    E.bag_lookup(p["cate_emb"], hist_cates)], -1)  # [B,T,2d]
    te = torch.cat([E.bag_lookup(p["item_emb"], target_item),
                    E.bag_lookup(p["cate_emb"], target_cate)], -1)  # [B,2d]

    h0 = torch.zeros((B, cfg.gru_dim), dtype=he.dtype, device=he.device)
    seq1, _ = L.gru_scan(p["gru1"], he, h0)               # interest extraction
    del he

    att_in = torch.cat([seq1, te[:, None, :].expand(B, T, te.shape[-1])], -1)
    att = L.mlp_apply(p["att"], att_in, act="relu")[..., 0]          # [B,T]
    del att_in
    att = torch.where(hist_mask > 0, att, -1e9)
    att = torch.softmax(att, dim=-1)

    # only the final state is kept: the [B, T, H] outputs go at once
    final = L.gru_scan(p["augru"], seq1, h0, cell=L.augru_cell, att=att)[1]
    del seq1

    # the reference's sum(he · mask, axis=1), item half first as he is cat
    ids = (hist_items.to(torch.int32), hist_cates.to(torch.int32))
    w = hist_mask.to(torch.float32)
    hist_sum = torch.cat(
        [bag_lookup_reduce(ids[0], w, p["item_emb"]["table"]),
         bag_lookup_reduce(ids[1], w, p["cate_emb"]["table"])], -1)
    z = torch.cat([final, te, hist_sum], -1)
    return L.mlp_apply(p["top"], z, act="relu")[:, 0]
