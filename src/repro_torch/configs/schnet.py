"""schnet [arXiv:1706.08566]: n_interactions=3 d_hidden=64 rbf=300
cutoff=10. The reference's ``configs/schnet.py``: ``BASE``, the per-cell
variants and the padded cell shapes, value for value, and its sharding
rules (``rules``). The ``CellDef`` cells wait (ROADMAP).

  full_graph_sm   cora-like: 2,708 nodes / 10,556 edges / d_feat 1,433
  minibatch_lg    reddit-like: 233k nodes, fanout (15, 10) sampler, 1,024
                  seeds
  ogb_products    2,449,029 nodes / 61,859,140 edges / d_feat 100 (full
                  batch)
  molecule        128 graphs x 30 nodes / 64 edges (energy regression)

SchNet's cfconv needs interatomic distances; for the non-geometric graph
cells the pipeline synthesizes 3-D positions so the RBF path runs at full
fidelity. Shapes are padded to multiples of 512; masks carry validity.
"""
import dataclasses

from repro_torch.models.gnn import SchNetConfig

BASE = SchNetConfig(name="schnet", n_interactions=3, d_hidden=64, n_rbf=300,
                    cutoff=10.0)

# per-cell model variants
CFG_SM = dataclasses.replace(BASE, d_in=1433, n_out=16, readout="none")
CFG_LG = dataclasses.replace(BASE, d_in=602, n_out=41, readout="none")
CFG_PROD = dataclasses.replace(BASE, d_in=100, n_out=47, readout="none")
CFG_MOL = dataclasses.replace(BASE, d_in=0, n_types=100, n_out=1,
                              readout="sum")

# padded cell shapes (original -> padded to /512)
CELL_SHAPES = {
    "full_graph_sm": dict(nodes=2708, edges=10556, pad_nodes=3072,
                          pad_edges=10752, cfg=CFG_SM),
    "minibatch_lg": dict(nodes=169984, edges=168960, pad_nodes=169984,
                         pad_edges=168960, cfg=CFG_LG),
    "ogb_products": dict(nodes=2449029, edges=61859140, pad_nodes=2449408,
                         pad_edges=61865984, cfg=CFG_PROD),
    "molecule": dict(nodes=3840, edges=8192, pad_nodes=4096,
                     pad_edges=8192, cfg=CFG_MOL, n_graphs=128),
}


def rules():
    """The reference's ``_rules``: SchNet's params are tiny (~100k),
    everything is replicated."""
    from repro_torch.models.module import ShardRules
    return ShardRules([(r".*", ())])
