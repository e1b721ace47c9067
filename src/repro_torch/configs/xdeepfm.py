"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed_dim=10, CIN layers
200-200-200, deep MLP 400-400. Vocab 2^20 per field (39 x 1,048,576 =
40,894,464 mega-table rows). The reference's ``configs/xdeepfm.py``:
``CONFIG``, the per-field offsets, its batch unpacking (``apply``),
sharding rules (``rules``) and cells (``get_arch``)."""
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


def _inputs(batch):
    import torch
    from repro_torch.configs.base import sds
    return {"sparse": sds((batch, CONFIG.n_sparse), torch.int32),
            "label": sds((batch,))}


def _specs(mesh, batch):
    from repro_torch.configs.base import dp, grid_axes
    ax = dp(mesh) if batch <= 65536 else grid_axes(mesh)
    return {"sparse": (ax, None), "label": (ax,)}


def get_arch():
    from repro_torch.configs import recsys_common as RC
    from repro_torch.configs.base import ArchDef, abstract
    from repro_torch.models.recsys import xdeepfm_init
    cells = RC.ctr_cells(_inputs, _specs, apply)
    cells["retrieval_cand"] = RC.retrieval_cell(CONFIG.embed_dim)
    return ArchDef(
        name="xdeepfm", family="recsys",
        abstract_params=lambda: abstract(
            lambda: xdeepfm_init(CONFIG, seed=0, device="cpu")[0]),
        rules=rules, cells=cells, opt="adamw_nomaster",
        notes="CIN outer-product interactions (the [B, H*m, D] "
              "intermediate dominates memory — batch sharded over full "
              "grid for bulk serve)")
