"""RecSys architectures: DLRM (MLPerf), DIEN (AUGRU), BST (behavior-sequence
transformer), xDeepFM (CIN). Port of ``repro/models/recsys.py``. Shared
skeleton, as in the reference:

    sparse ids --mega-table lookup--> field embeddings
    dense feats --bottom MLP--------> dense embedding
    interaction (dot / augru-attn / transformer / CIN)
    top MLP -> logit

The params are the reference's trees, field for field: DIEN's as an
``nn.ModuleDict`` (``models.module.as_module``; ``models.module.
tensor_tree`` gives the plain dicts a train step takes), DLRM's, BST's and
xDeepFM's as plain nested dicts of tensors. ``convert`` carries the
reference's weights across. Each forward follows the reference line by
line. DIEN's history sum (``recsys.py:120``: the history rows weighted by
the mask) is ``bag_lookup_reduce`` over the item and the category table
(the embedding_bag kernel on the card, two launches a forward) when no
gradient is asked; under a gradient it is the reference's own masked sum
of the looked-up rows, because the kernel has no backward and its output
would cut the tables' gradient.

On a mesh (the registry's cells, ``launch/steps``) a model runs inside
``models.module.on_batch_rows`` on each rank's own rows, its replicated
params as local tensors, and the tables its rules split on their rows
(DLRM's and xDeepFM's mega-tables, xDeepFM's linear table, DIEN's and
BST's item tables) read through ``models/embedding``'s row-sharded path:
DIEN's item history sum is then one embedding_bag launch a rank over its
own bags' looked-up rows (``embedding.rows_reduce``), its category
table's one launch as before.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import resolve_device
from repro_torch.kernels.embedding_bag.ops import bag_lookup_reduce
from repro_torch.models import embedding as E
from repro_torch.models import layers as L
from repro_torch.models.attention import AttnConfig, _qkv, _sdpa, attn_init
from repro_torch.models.module import (as_module, grad_asked,
                                       is_row_sharded)


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


# ================================================================== DLRM ====
@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 128
    bot_mlp: tuple[int, ...] = (512, 256, 128)
    top_mlp: tuple[int, ...] = (1024, 1024, 512, 256, 1)
    # Criteo-1TB vocab sizes, MLPerf 40M row cap applied
    vocab_sizes: tuple[int, ...] = (
        40_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
        40_000_000, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976, 14,
        40_000_000, 40_000_000, 40_000_000, 590_152, 12_973, 108, 36)
    param_dtype: str = "float32"

    @property
    def total_rows(self) -> int:
        return int(sum(self.vocab_sizes))


def dlrm_init(cfg: DLRMConfig, *, seed: int = 0,
              device: str | torch.device = "cuda"):
    """-> (params {"tables": {"mega"}, "bot", "top"}, offsets [n_sparse]
    int32), random on ``device`` with the reference's distributions."""
    gen = _gen(seed, device)
    dt = getattr(torch, cfg.param_dtype)
    tables, offsets = E.tables_init(gen, list(cfg.vocab_sizes),
                                    cfg.embed_dim, dt)
    n_int = cfg.n_sparse + 1
    d_int = n_int * (n_int - 1) // 2 + cfg.embed_dim
    return {"tables": tables,
            "bot": L.mlp_init(gen, [cfg.n_dense, *cfg.bot_mlp], dt),
            "top": L.mlp_init(gen, [d_int, *cfg.top_mlp], dt)}, offsets


def dlrm_apply(p, cfg: DLRMConfig, offsets, dense, sparse_ids):
    """dense [B, n_dense], sparse_ids [B, n_sparse] -> logit [B]: the
    bottom MLP, the fields' rows, every pairwise dot of the F + 1 vectors
    (fp32, the upper triangle above the diagonal in row-major order, as
    ``jnp.triu_indices(F + 1, k=1)``) and the top MLP."""
    x_dense = L.mlp_apply(p["bot"], dense, act="relu", final_act=True)
    emb = E.tables_lookup(p["tables"], offsets, sparse_ids)     # [B, F, D]
    feats = torch.cat([x_dense[:, None, :], emb], dim=1)        # [B, F+1, D]
    f32 = feats.to(torch.float32)
    inter = torch.bmm(f32, f32.transpose(1, 2))                 # [B, F+1, F+1]
    n = feats.shape[1]
    iu, ju = torch.triu_indices(n, n, offset=1, device=feats.device)
    flat = inter[:, iu, ju].to(dense.dtype)                     # [B, F(F+1)/2]
    z = torch.cat([x_dense, flat], dim=-1)
    return L.mlp_apply(p["top"], z, act="relu")[:, 0]


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
    A row whose mask is all 0 attends uniformly, as in the reference.
    Under a gradient (``models.module.grad_asked`` of the params and the
    mask) the history sum is the masked sum of the looked-up rows; else
    two ``bag_lookup_reduce`` calls."""
    B, T = hist_items.shape
    grad = grad_asked(p, hist_mask)
    item_rows = E.bag_lookup(p["item_emb"], hist_items)            # [B,T,d]
    he = torch.cat([item_rows, E.bag_lookup(p["cate_emb"], hist_cates)],
                   -1)                                             # [B,T,2d]
    # a row-sharded item table's history sum reads these rows again
    item_rows = item_rows if is_row_sharded(p["item_emb"]["table"]) \
        else None
    te = torch.cat([E.bag_lookup(p["item_emb"], target_item),
                    E.bag_lookup(p["cate_emb"], target_cate)], -1)  # [B,2d]

    h0 = torch.zeros((B, cfg.gru_dim), dtype=he.dtype, device=he.device)
    seq1, _ = L.gru_scan(p["gru1"], he, h0)               # interest extraction
    if not grad:
        del he

    att_in = torch.cat([seq1, te[:, None, :].expand(B, T, te.shape[-1])], -1)
    att = L.mlp_apply(p["att"], att_in, act="relu")[..., 0]          # [B,T]
    del att_in
    att = torch.where(hist_mask > 0, att, -1e9)
    att = torch.softmax(att, dim=-1)

    # only the final state is kept: the [B, T, H] outputs go at once
    final = L.gru_scan(p["augru"], seq1, h0, cell=L.augru_cell, att=att)[1]
    del seq1

    if grad:
        # the reference's own masked sum: differentiable in the tables
        hist_sum = torch.sum(he * hist_mask[..., None].to(he.dtype), dim=1)
    else:
        # the reference's sum(he · mask, axis=1), item half first as he is
        # cat, through the embedding_bag kernel on the card
        ids = (hist_items.to(torch.int32), hist_cates.to(torch.int32))
        w = hist_mask.to(torch.float32)
        hist_sum = torch.cat(
            [E.rows_reduce(p["item_emb"]["table"], ids[0], w,
                           bag_lookup_reduce, rows=item_rows),
             E.rows_reduce(p["cate_emb"]["table"], ids[1], w,
                           bag_lookup_reduce)], -1)
    z = torch.cat([final, te, hist_sum], -1)
    return L.mlp_apply(p["top"], z, act="relu")[:, 0]


# =================================================================== BST =====
@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    mlp: tuple[int, ...] = (1024, 512, 256)
    item_vocab: int = 1_000_000
    n_other_feats: int = 8
    other_vocab: int = 100_000
    param_dtype: str = "float32"


def _bst_attn(cfg: BSTConfig) -> AttnConfig:
    return AttnConfig(d_model=cfg.embed_dim, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_heads,
                      head_dim=max(1, cfg.embed_dim // cfg.n_heads),
                      use_rope=False)


def bst_init(cfg: BSTConfig, *, seed: int = 0,
             device: str | torch.device = "cuda") -> dict:
    """{"item_emb", "pos_emb", "other_emb", "blocks": {"blk{i}": {"ln1",
    "attn", "ln2", "ff"}}, "top"}, random on ``device``."""
    gen = _gen(seed, device)
    dt = getattr(torch, cfg.param_dtype)
    d = cfg.embed_dim
    acfg = _bst_attn(cfg)
    blocks = {f"blk{i}": {"ln1": L.layernorm_init(d, dt, gen.device),
                          "attn": attn_init(gen, acfg, dt),
                          "ln2": L.layernorm_init(d, dt, gen.device),
                          "ff": L.mlp_init(gen, [d, 4 * d, d], dt)}
              for i in range(cfg.n_blocks)}
    seq_total = (cfg.seq_len + 1) * d
    other_total = cfg.n_other_feats * d
    return {"item_emb": E.bag_init(gen, cfg.item_vocab, d, dt),
            "pos_emb": E.bag_init(gen, cfg.seq_len + 1, d, dt),
            "other_emb": E.bag_init(gen, cfg.other_vocab, d, dt),
            "blocks": blocks,
            "top": L.mlp_init(gen, [seq_total + other_total, *cfg.mlp, 1],
                              dt)}


def bst_apply(p, cfg: BSTConfig, hist_items, target_item, other_ids):
    """hist_items [B, T], target_item [B], other_ids [B, n_other] -> logit
    [B]: the behaviour sequence and the target with learned positions,
    ``n_blocks`` pre-norm transformer blocks attending across the whole
    sequence (``_qkv`` + ``_sdpa`` under an all-true mask), then the top
    MLP over the flattened sequence and the other fields."""
    B, T = hist_items.shape
    seq = torch.cat([hist_items, target_item[:, None]], dim=1)   # [B, T+1]
    x = E.bag_lookup(p["item_emb"], seq)
    x = x + E.bag_lookup(p["pos_emb"],
                         torch.arange(T + 1, device=x.device))[None]
    acfg = _bst_attn(cfg)
    pos = torch.arange(T + 1, device=x.device).expand(B, T + 1)
    mask = torch.ones((B, T + 1, T + 1), dtype=torch.bool, device=x.device)
    for i in range(cfg.n_blocks):
        bp = p["blocks"][f"blk{i}"]
        h = L.layernorm_apply(bp["ln1"], x)
        q, k, v = _qkv(bp["attn"], acfg, h, pos)
        x = x + L.dense_apply(bp["attn"]["o_proj"], _sdpa(q, k, v, mask,
                                                          acfg))
        h = L.layernorm_apply(bp["ln2"], x)
        x = x + L.mlp_apply(bp["ff"], h, act="relu")
    other = E.bag_lookup(p["other_emb"], other_ids).reshape(B, -1)
    z = torch.cat([x.reshape(B, -1), other], dim=-1)
    return L.mlp_apply(p["top"], z, act="relu")[:, 0]


# ================================================================ xDeepFM ====
@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_sparse: int = 39
    embed_dim: int = 10
    cin_layers: tuple[int, ...] = (200, 200, 200)
    mlp: tuple[int, ...] = (400, 400)
    vocab_per_field: int = 1_000_000
    param_dtype: str = "float32"


def xdeepfm_init(cfg: XDeepFMConfig, *, seed: int = 0,
                 device: str | torch.device = "cuda"):
    """-> (params {"tables", "cin": {"w{i}"}, "linear", "mlp", "cin_out"},
    offsets [n_sparse] int32); CIN weights [H_prev · m, H] ~ normal ·
    0.01."""
    gen = _gen(seed, device)
    dt = getattr(torch, cfg.param_dtype)
    tables, offsets = E.tables_init(
        gen, [cfg.vocab_per_field] * cfg.n_sparse, cfg.embed_dim, dt)
    cin, h_prev = {}, cfg.n_sparse
    for i, h in enumerate(cfg.cin_layers):
        cin[f"w{i}"] = L._normal(gen, (h_prev * cfg.n_sparse, h), 0.01, dt)
        h_prev = h
    return {"tables": tables, "cin": cin,
            "linear": E.bag_init(gen, cfg.vocab_per_field * cfg.n_sparse, 1,
                                 dt),
            "mlp": L.mlp_init(gen, [cfg.n_sparse * cfg.embed_dim, *cfg.mlp,
                                    1], dt),
            "cin_out": L.dense_init(gen, sum(cfg.cin_layers), 1, dt)}, offsets


def xdeepfm_apply(p, cfg: XDeepFMConfig, offsets, sparse_ids):
    """sparse_ids [B, n_sparse] -> logit [B]: the linear term, the deep
    MLP and the CIN. A CIN layer is the reference's two einsums,
    accumulated in fp32: x_k[b, h, D] = sum_{i, j} W[i·m + j, h] ·
    x_{k-1}[b, i, D] · x0[b, j, D], each layer's maps summed over D."""
    B = sparse_ids.shape[0]
    x0 = E.tables_lookup(p["tables"], offsets, sparse_ids)      # [B, m, D]
    m, D = cfg.n_sparse, cfg.embed_dim
    xs, pooled = x0, []
    for i in range(len(cfg.cin_layers)):
        z = torch.einsum("bhd,bmd->bhmd", xs.to(torch.float32),
                         x0.to(torch.float32))         # outer product
        z = z.reshape(B, xs.shape[1] * m, D).to(x0.dtype)
        xs = torch.einsum("bid,ih->bhd", z.to(torch.float32),
                          p["cin"][f"w{i}"].to(torch.float32)).to(x0.dtype)
        pooled.append(xs.sum(-1))                               # [B, H_k]
    cin_feat = torch.cat(pooled, dim=-1)
    lin = E.tables_lookup({"mega": p["linear"]}, offsets,
                          sparse_ids)[..., 0].sum(-1)
    deep = L.mlp_apply(p["mlp"], x0.reshape(B, -1), act="relu")[:, 0]
    cin_logit = L.dense_apply(p["cin_out"], cin_feat)[:, 0]
    return lin + deep + cin_logit


# ======================================================== retrieval tower ====
def retrieval_score(query_vec, item_table):
    """One query against every candidate, fp32: [d] x [N, d] -> [N] (the
    brute-force baseline that IRLI's learned index replaces)."""
    return torch.matmul(item_table.to(torch.float32),
                        query_vec.to(torch.float32))
