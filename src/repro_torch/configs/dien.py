"""dien [arXiv:1809.03672]: embed_dim=18 seq_len=100 gru_dim=108 mlp=200-80,
AUGRU interest evolution. Item vocab 1,048,576 (2^20), category vocab 100k.
The reference's ``configs/dien.CONFIG``, value for value, its batch
unpacking and its sharding rules (``rules``, ``:40``), and its cells
(``get_arch``: ``recsys_common.ctr_cells`` and the ``retrieval_cand``
cell, whose width is ``RETRIEVAL_DIM``, the reference's ``CONFIG.embed_dim
* 2``, ``configs/dien.py:51``). ``BATCHES`` are the serve batches of
``configs/recsys_common.BATCHES``."""
from repro_torch.models.recsys import DIENConfig, dien_apply

CONFIG = DIENConfig(item_vocab=1_048_576, cate_vocab=100_000)

#: online inference and offline scoring batches
BATCHES = {"serve_p99": 512, "serve_bulk": 262_144}

#: the two-tower retrieval cell's embedding width: item + category concat
RETRIEVAL_DIM = CONFIG.embed_dim * 2


def rules():
    """The reference's ``_rules``: the item tables' rows over the whole
    ("data", "model") grid, everything else replicated."""
    from repro_torch.models.module import ShardRules
    return ShardRules([
        (r"item_emb/table", (("data", "model"), None)),
        (r"item_table/table", (("data", "model"), None)),
        (r".*", ()),
    ])


def apply(params, batch):
    """The reference's ``_apply``: a batch dict -> logit [B]."""
    return dien_apply(params, CONFIG, batch["hist_items"],
                      batch["hist_cates"], batch["target_item"],
                      batch["target_cate"], batch["hist_mask"])


def _inputs(batch):
    import torch
    from repro_torch.configs.base import sds
    T = CONFIG.seq_len
    return {"hist_items": sds((batch, T), torch.int32),
            "hist_cates": sds((batch, T), torch.int32),
            "target_item": sds((batch,), torch.int32),
            "target_cate": sds((batch,), torch.int32),
            "hist_mask": sds((batch, T)),
            "label": sds((batch,))}


def _specs(mesh, batch):
    from repro_torch.configs.base import dp, grid_axes
    ax = dp(mesh) if batch <= 65536 else grid_axes(mesh)
    return {"hist_items": (ax, None), "hist_cates": (ax, None),
            "target_item": (ax,), "target_cate": (ax,),
            "hist_mask": (ax, None), "label": (ax,)}


def get_arch():
    from repro_torch.configs import recsys_common as RC
    from repro_torch.configs.base import ArchDef, abstract
    from repro_torch.models.recsys import dien_init
    cells = RC.ctr_cells(_inputs, _specs, apply)
    cells["retrieval_cand"] = RC.retrieval_cell(RETRIEVAL_DIM)
    return ArchDef(
        name="dien", family="recsys",
        abstract_params=lambda: abstract(dien_init, CONFIG, seed=0,
                                         device="cpu"),
        rules=rules, cells=cells, opt="adamw_nomaster",
        notes="AUGRU recurrence (100 steps); attention-gated update; serve "
              "cells exercise the sequential decode analogue")
