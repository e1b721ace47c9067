"""Rank program of tests/test_torch_mesh_ctr.py. This module imports torch,
numpy and the port only (no jax), so a spawned rank starts quickly.

``ctr_ranks`` runs the CTR, retrieval and SchNet steps of the registry's
cells on DTensors over a (data 2, model 2) mesh of gloo ranks, at narrow
widths, from the whole params and batches the test wrote to
``mesh_ctr_in.npz``: one train step of each model (the state placed by
the arch's ``rules()`` and ``opt_state_specs``, the batch by its cells'
in_specs), the serve step in both serve layouts (rows over the data axes
and over every axis), the retrieval step over a row-sharded item table,
and SchNet's node step (nodes and edges split, and whole) and energy
step. Rank 0 writes the whole results to ``mesh_ctr_out.npz``; every rank
checks that the state kept its placements. :func:`cases` builds the same
models and steps for the test's meshless side.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

LR = 1e-3
#: the narrow models: every table's rows odd, so that the four blocks of a
#: row-sharded table are uneven (ceil(V / 4) rows a block, the last fewer)
DLRM = dict(vocab_sizes=(101, 51, 31), n_sparse=3, n_dense=4, embed_dim=8,
            bot_mlp=(16, 8), top_mlp=(16, 1))
BST = dict(embed_dim=16, seq_len=8, n_blocks=1, n_heads=2, mlp=(32, 8),
           item_vocab=301, n_other_feats=3, other_vocab=40)
XDEEPFM = dict(n_sparse=5, embed_dim=4, cin_layers=(8, 8), mlp=(16,),
               vocab_per_field=61)
DIEN = dict(embed_dim=8, seq_len=12, gru_dim=16, mlp=(16, 8), item_vocab=203,
            cate_vocab=50)
#: the retrieval table's rows, width, queries and k; rows TIE_A and TIE_B
#: (blocks 0 and 1) are equal and score first for query 0
RET_N, RET_D, RET_Q, RET_K = 403, 8, 2, 10
TIE_A, TIE_B = 5, 150
#: SchNet: nodes, edges, width; the molecule batch's graphs, atoms, bonds
NODE_N, NODE_E, NODE_D = 48, 160, 8
MOL_G, MOL_N, MOL_E = 8, 6, 12
#: the CTR rows of a batch
ROWS = {"dlrm": 32, "bst": 8, "xdeepfm": 16, "dien": 16}


def _offsets(vocabs):
    import torch
    return torch.tensor([0, *np.cumsum(vocabs)[:-1]], dtype=torch.int32)


def cases() -> dict:
    """{name: (apply_fn, the config module whose ``rules()`` and
    ``_specs`` the cells use)} of the four CTR models at the narrow
    widths."""
    from repro_torch.configs import bst, dien, dlrm_mlperf, xdeepfm
    from repro_torch.models import recsys as RS
    dl = dataclasses.replace(RS.DLRMConfig(), **DLRM)
    bc = RS.BSTConfig(**BST)
    xc = RS.XDeepFMConfig(**XDEEPFM)
    ec = RS.DIENConfig(**DIEN)
    doff = _offsets(DLRM["vocab_sizes"])
    xoff = _offsets([XDEEPFM["vocab_per_field"]] * XDEEPFM["n_sparse"])
    keys = ("hist_items", "hist_cates", "target_item", "target_cate",
            "hist_mask")
    return {
        "dlrm": (lambda p, b: RS.dlrm_apply(p, dl, doff, b["dense"],
                                            b["sparse"]), dlrm_mlperf),
        "bst": (lambda p, b: RS.bst_apply(p, bc, b["hist_items"],
                                          b["target_item"], b["other_ids"]),
                bst),
        "xdeepfm": (lambda p, b: RS.xdeepfm_apply(p, xc, xoff, b["sparse"]),
                    xdeepfm),
        "dien": (lambda p, b: RS.dien_apply(p, ec, *(b[k] for k in keys)),
                 dien),
    }


def schnet_cfgs():
    from repro_torch.models.gnn import SchNetConfig
    return (SchNetConfig(d_in=NODE_D, n_out=5, readout="none", n_rbf=16,
                         d_hidden=16),
            SchNetConfig(d_in=0, n_types=10, n_out=1, readout="sum",
                         n_rbf=16, d_hidden=16))


def split(z, prefix: str) -> dict:
    """The npz arrays under ``prefix|`` as a nested dict ("a|b|c" keys)."""
    out: dict = {}
    for key in z.files:
        if not key.startswith(prefix + "|"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("|")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key]
    return out


def flat(tree, prefix: str) -> dict:
    """A nested dict of arrays -> {"prefix|a|b": array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}|{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _tensors(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def _whole(tree):
    from repro_torch.models.module import is_dtensor
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if is_dtensor(tree):
        tree = tree.full_tensor()
    return tree.detach().numpy()


def _placements(tree):
    if isinstance(tree, dict):
        return {k: _placements(v) for k, v in tree.items()}
    return tuple(tree.placements)


def _train(step, opt, params, batch_np, pspecs, bspecs, mesh) -> dict:
    """One train step on DTensors -> the whole loss, params and AdamW
    moments after it; raises unless every state leaf kept its
    placements."""
    from repro_torch.launch import steps as S
    from repro_torch.models.module import place_tree
    ospecs = S.opt_state_specs("adamw_nomaster", params, pspecs, mesh)
    state = S.place_train_state({"params": params, "opt": opt.init(params)},
                                pspecs, ospecs, mesh)
    before = _placements({"params": state["params"],
                          "m": state["opt"]["m"], "v": state["opt"]["v"]})
    batch = place_tree(_tensors(batch_np), bspecs, mesh)
    state, metrics = step(state, batch)
    after = _placements({"params": state["params"], "m": state["opt"]["m"],
                         "v": state["opt"]["v"]})
    assert after == before, (after, before)
    return {"loss": metrics["loss"].numpy(),
            "params": _whole(state["params"]),
            "m": _whole(state["opt"]["m"]), "v": _whole(state["opt"]["v"])}


def ctr_ranks(rank: int, world: int, tmp: str) -> None:
    """Every mesh case (see the module docstring) on this rank; rank 0
    writes the results."""
    import torch

    from repro_torch.configs.base import grid_axes
    from repro_torch.configs.schnet import rules as schnet_rules
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.module import place_tree
    torch.set_num_threads(1)
    z = np.load(Path(tmp) / "mesh_ctr_in.npz")
    mesh = make_host_mesh(world, model_axis=2, device_type="cpu")
    out: dict = {}
    for name, (apply_fn, mod) in cases().items():
        # the train step updates its state in place, and a placed block
        # may share the whole tensor's storage: each step its own copy
        params = _tensors(split(z, f"{name}|params"))
        batch = split(z, f"{name}|batch")
        pspecs = mod.rules().specs(params)
        step, opt = S.build_ctr_train_step(apply_fn, lr=LR)
        res = _train(step, opt, params, batch, pspecs,
                     mod._specs(mesh, ROWS[name]), mesh)
        out.update(flat(res, f"{name}|train"))
        serve = S.build_ctr_serve(apply_fn)
        placed = place_tree(_tensors(split(z, f"{name}|params")), pspecs,
                            mesh)
        for layout, rows in (("p99", ROWS[name]), ("bulk", 1 << 20)):
            specs = mod._specs(mesh, rows)
            if layout == "bulk":
                assert specs["label"] == (grid_axes(mesh),)
            prob = serve(placed, place_tree(_tensors(batch), specs, mesh))[
                "prob"]
            assert tuple(prob.placements) == tuple(
                place_tree(_tensors(batch), specs, mesh)["label"].placements)
            out[f"{name}|prob_{layout}"] = prob.full_tensor().numpy()

    ret = S.build_retrieval_serve(RET_K)
    table = torch.from_numpy(z["retrieval|table"])
    res = ret(place_tree({"item_table": {"table": table}},
                         {"item_table": {"table": (("data", "model"),
                                                   None)}}, mesh),
              place_tree({"query": torch.from_numpy(z["retrieval|query"])},
                         {"query": ()}, mesh))
    out["retrieval|ids"] = res["ids"].numpy()
    out["retrieval|scores"] = res["scores"].numpy()

    node_cfg, mol_cfg = schnet_cfgs()
    g = grid_axes(mesh)
    for name, cfg, build, specs in (
            ("node", node_cfg, lambda c: S.build_gnn_node_train(c, lr=LR),
             {"feats": (g, None), "src": (g,), "dst": (g,), "dist": (g,),
              "labels": (g,), "node_mask": (g,)}),
            ("node_whole", node_cfg,
             lambda c: S.build_gnn_node_train(c, lr=LR),
             dict.fromkeys(("feats", "src", "dst", "dist", "labels",
                            "node_mask"), ())),
            ("molecule", mol_cfg,
             lambda c: S.build_gnn_energy_train(c, MOL_G, lr=LR),
             {"types": (g,), "src": (g,), "dst": (g,), "dist": (g,),
              "graph_ids": (g,), "energy": ()})):
        src = "node" if name == "node_whole" else name
        params = _tensors(split(z, f"{src}|params"))
        step, opt = build(cfg)
        res = _train(step, opt, params, split(z, f"{src}|batch"),
                     schnet_rules().specs(params), specs, mesh)
        out.update(flat(res, f"{name}|train"))
    if rank == 0:
        np.savez(Path(tmp) / "mesh_ctr_out.npz", **out)
