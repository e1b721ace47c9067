"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed_dim=10, CIN layers
200-200-200, deep MLP 400-400. Vocab 2^20 per field (39 x 1,048,576 =
40,894,464 mega-table rows). The reference's ``configs/xdeepfm.py``:
``CONFIG``, the per-field offsets, its batch unpacking (``apply``) and
sharding rules (``rules``). The cells wait (ROADMAP)."""
import numpy as np

from repro_torch.models.recsys import XDeepFMConfig, xdeepfm_apply

CONFIG = XDeepFMConfig(vocab_per_field=1_048_576)
_OFFSETS = np.asarray(
    [0] + list(np.cumsum([CONFIG.vocab_per_field] * CONFIG.n_sparse)[:-1]),
    np.int32)


def rules():
    """The reference's ``_rules``: the mega-table's and the linear table's
    rows over the whole ("data", "model") grid, everything else
    replicated."""
    from repro_torch.models.module import ShardRules
    return ShardRules([
        (r"tables/mega/table", (("data", "model"), None)),
        (r"linear/table", (("data", "model"), None)),
        (r"item_table/table", (("data", "model"), None)),
        (r".*", ()),
    ])


def apply(params, batch):
    """The reference's ``_apply``: a batch dict -> logit [B]."""
    import torch
    offsets = torch.as_tensor(_OFFSETS, device=batch["sparse"].device)
    return xdeepfm_apply(params, CONFIG, offsets, batch["sparse"])
