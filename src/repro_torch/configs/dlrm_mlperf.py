"""dlrm-mlperf [arXiv:1906.00091]: MLPerf DLRM (Criteo 1TB): 13 dense +
26 sparse features, embed_dim 128, bot MLP 13-512-256-128, top MLP
1024-1024-512-256-1, dot interaction. Vocab sizes: Criteo-1TB with the
MLPerf 40M row cap; total 204,184,588 rows, padded (+500) to a multiple of
512. The reference's ``configs/dlrm_mlperf.py``: ``CONFIG``, the padded
vocabularies and offsets (int32, as the reference's), its batch unpacking
(``apply``), sharding rules (``rules``) and cells (``get_arch``)."""
import dataclasses

import numpy as np

from repro_torch.models.recsys import DLRMConfig, dlrm_apply, dlrm_init

CONFIG = DLRMConfig()
_PAD_ROWS = (-CONFIG.total_rows) % 512
_VOCABS = list(CONFIG.vocab_sizes[:-1]) + [CONFIG.vocab_sizes[-1] + _PAD_ROWS]
_OFFSETS = np.asarray([0] + list(np.cumsum(_VOCABS)[:-1]), np.int32)
TOTAL_ROWS = int(sum(_VOCABS))


def init(*, seed: int = 0, device="cuda") -> dict:
    """Random params of the padded mega-table config on ``device`` (the
    reference's ``_init``): 104.5 GB of fp32 table."""
    cfg = dataclasses.replace(CONFIG, vocab_sizes=tuple(_VOCABS))
    return dlrm_init(cfg, seed=seed, device=device)[0]


def rules():
    """The reference's ``_rules``: the mega-table's rows over the whole
    ("data", "model") grid, the MLPs replicated."""
    from repro_torch.models.module import ShardRules
    return ShardRules([
        (r"tables/mega/table", (("data", "model"), None)),
        (r"item_table/table", (("data", "model"), None)),
        (r"(bot|top)/fc\d+/(kernel|bias)", ()),
    ])


def apply(params, batch):
    """The reference's ``_apply``: a batch dict -> logit [B]."""
    import torch
    offsets = torch.as_tensor(_OFFSETS, device=batch["sparse"].device)
    return dlrm_apply(params, CONFIG, offsets, batch["dense"],
                      batch["sparse"])


def _inputs(batch):
    import torch
    from repro_torch.configs.base import sds
    return {"dense": sds((batch, CONFIG.n_dense)),
            "sparse": sds((batch, CONFIG.n_sparse), torch.int32),
            "label": sds((batch,))}


def _specs(mesh, batch):
    from repro_torch.configs.base import dp, grid_axes
    ax = dp(mesh) if batch <= 65536 else grid_axes(mesh)
    return {"dense": (ax, None), "sparse": (ax, None), "label": (ax,)}


def get_arch():
    from repro_torch.configs import recsys_common as RC
    from repro_torch.configs.base import ArchDef, abstract
    cells = RC.ctr_cells(_inputs, _specs, apply)
    cells["retrieval_cand"] = RC.retrieval_cell(CONFIG.embed_dim)
    return ArchDef(
        name="dlrm-mlperf", family="recsys",
        abstract_params=lambda: abstract(init, seed=0, device="cpu"),
        rules=rules, cells=cells, opt="adamw_nomaster",
        notes=f"mega-table {TOTAL_ROWS} rows x 128 "
              f"(~{TOTAL_ROWS * 128 * 4 / 2 ** 30:.0f} GiB fp32) "
              "row-sharded over grid; IRLI accelerates retrieval_cand")
