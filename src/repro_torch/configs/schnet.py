"""schnet [arXiv:1706.08566]: n_interactions=3 d_hidden=64 rbf=300
cutoff=10. The reference's ``configs/schnet.py``: ``BASE``, the per-cell
variants and the padded cell shapes, value for value, its sharding rules
(``rules``) and its cells (``get_arch``).

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


def _node_cell(name: str):
    import torch

    from repro_torch.configs.base import CellDef, abstract, grid_axes, sds
    from repro_torch.launch import steps as S
    from repro_torch.models.gnn import schnet_init
    sh = CELL_SHAPES[name]
    cfg = sh["cfg"]
    N, E = sh["pad_nodes"], sh["pad_edges"]
    replicate = N < 100_000  # small graphs: replication beats scatter traffic

    def inputs(mesh):
        return {"feats": sds((N, cfg.d_in)), "src": sds((E,), torch.int32),
                "dst": sds((E,), torch.int32), "dist": sds((E,)),
                "labels": sds((N,), torch.int32), "node_mask": sds((N,))}

    def in_specs(mesh):
        if replicate:
            return {k: () for k in
                    ("feats", "src", "dst", "dist", "labels", "node_mask")}
        g = grid_axes(mesh)
        return {"feats": (g, None), "src": (g,), "dst": (g,), "dist": (g,),
                "labels": (g,), "node_mask": (g,)}

    return CellDef(
        kind="train", inputs=inputs, in_specs=in_specs,
        params=lambda mesh: abstract(schnet_init, cfg, seed=0,
                                     device="cpu"),
        step=lambda: S.build_gnn_node_train(cfg)[0])


def _molecule_cell():
    import torch

    from repro_torch.configs.base import CellDef, abstract, grid_axes, sds
    from repro_torch.launch import steps as S
    from repro_torch.models.gnn import schnet_init
    sh = CELL_SHAPES["molecule"]
    cfg = sh["cfg"]
    N, E, G = sh["pad_nodes"], sh["pad_edges"], sh["n_graphs"]

    def inputs(mesh):
        return {"types": sds((N,), torch.int32), "src": sds((E,), torch.int32),
                "dst": sds((E,), torch.int32), "dist": sds((E,)),
                "graph_ids": sds((N,), torch.int32), "energy": sds((G,))}

    def in_specs(mesh):
        g = grid_axes(mesh)
        return {"types": (g,), "src": (g,), "dst": (g,), "dist": (g,),
                "graph_ids": (g,), "energy": ()}

    return CellDef(
        kind="train", inputs=inputs, in_specs=in_specs,
        params=lambda mesh: abstract(schnet_init, cfg, seed=0,
                                     device="cpu"),
        step=lambda: S.build_gnn_energy_train(cfg, G)[0])


def get_arch():
    from repro_torch.configs.base import ArchDef, abstract
    from repro_torch.models.gnn import schnet_init
    cells = {
        "full_graph_sm": _node_cell("full_graph_sm"),
        "minibatch_lg": _node_cell("minibatch_lg"),
        "ogb_products": _node_cell("ogb_products"),
        "molecule": _molecule_cell(),
    }
    return ArchDef(
        name="schnet", family="gnn",
        abstract_params=lambda: abstract(schnet_init, CFG_SM, seed=0,
                                         device="cpu"),
        rules=rules, cells=cells, opt="adamw_nomaster",
        notes=("segment_sum message passing; params replicated (tiny), "
               "edges/nodes sharded over the full grid for large cells; "
               "IRLI inapplicable — no large discrete retrieval space"))
