"""bst [arXiv:1905.06874]: Behavior Sequence Transformer (Alibaba):
embed_dim=32 seq_len=20, 1 transformer block of 8 heads, MLP 1024-512-256.
The reference's ``configs/bst.py``: ``CONFIG``, its batch unpacking
(``apply``) and sharding rules (``rules``). The cells wait (ROADMAP)."""
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
