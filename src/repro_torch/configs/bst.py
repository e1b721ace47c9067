"""bst [arXiv:1905.06874]: Behavior Sequence Transformer (Alibaba):
embed_dim=32 seq_len=20, 1 transformer block of 8 heads, MLP 1024-512-256.
The reference's ``configs/bst.py``: ``CONFIG``, its batch unpacking
(``apply``), sharding rules (``rules``) and cells (``get_arch``)."""
from repro_torch.models.recsys import BSTConfig, bst_apply

CONFIG = BSTConfig(item_vocab=1_048_576, other_vocab=100_000)


def rules():
    """The reference's ``_rules``: the item table's rows over the whole
    ("data", "model") grid, everything else replicated."""
    from repro_torch.models.module import ShardRules
    return ShardRules([
        (r"item_emb/table", (("data", "model"), None)),
        (r"item_table/table", (("data", "model"), None)),
        (r".*", ()),
    ])


def apply(params, batch):
    """The reference's ``_apply``: a batch dict -> logit [B]."""
    return bst_apply(params, CONFIG, batch["hist_items"],
                     batch["target_item"], batch["other_ids"])


def _inputs(batch):
    import torch
    from repro_torch.configs.base import sds
    return {"hist_items": sds((batch, CONFIG.seq_len), torch.int32),
            "target_item": sds((batch,), torch.int32),
            "other_ids": sds((batch, CONFIG.n_other_feats), torch.int32),
            "label": sds((batch,))}


def _specs(mesh, batch):
    from repro_torch.configs.base import dp, grid_axes
    ax = dp(mesh) if batch <= 65536 else grid_axes(mesh)
    return {"hist_items": (ax, None), "target_item": (ax,),
            "other_ids": (ax, None), "label": (ax,)}


def get_arch():
    from repro_torch.configs import recsys_common as RC
    from repro_torch.configs.base import ArchDef, abstract
    from repro_torch.models.recsys import bst_init
    cells = RC.ctr_cells(_inputs, _specs, apply)
    cells["retrieval_cand"] = RC.retrieval_cell(CONFIG.embed_dim)
    return ArchDef(
        name="bst", family="recsys",
        abstract_params=lambda: abstract(bst_init, CONFIG, seed=0,
                                         device="cpu"),
        rules=rules, cells=cells, opt="adamw_nomaster",
        notes="transformer-over-behavior-sequence; bidirectional attention")
