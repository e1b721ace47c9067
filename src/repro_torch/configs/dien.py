"""dien [arXiv:1809.03672]: embed_dim=18 seq_len=100 gru_dim=108 mlp=200-80,
AUGRU interest evolution. Item vocab 1,048,576 (2^20), category vocab 100k.
The reference's ``configs/dien.CONFIG``, value for value, its batch
unpacking and its sharding rules (``rules``, ``:40``); the serve batches
of ``configs/recsys_common.BATCHES``. The cells are mesh machinery and
are not ported; the ``retrieval_cand`` cell's width is ``RETRIEVAL_DIM``
(the reference's ``CONFIG.embed_dim * 2``, ``configs/dien.py:51``)."""
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
