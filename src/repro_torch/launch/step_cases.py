"""One train step of each model family at the smoke tests' reduced sizes,
for holding a step on one device to the same step on another from the
same state and batch (the card against the CPU).

``step_cases(seed)`` -> {name: (init, (step, opt), batch)}: ``init(device)``
draws the params from ``seed`` (the same draws on every device),
``(step, opt)`` is the train step builder's pair and ``batch`` is host
data. The cases are the launcher's five ``LM_VARIANTS`` (``n_micro=2``),
mixtral's variant again under the k-choice router (``kchoice`` in its
train step), and the reference's ``tests/test_smoke_archs.py`` DLRM, BST,
xDeepFM, DIEN and both SchNet steps.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["step_cases"]


def step_cases(seed: int = 0) -> dict:
    from repro_torch.data.synthetic import molecule_batch
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import LM_VARIANTS
    from repro_torch.models import gnn as G
    from repro_torch.models import recsys as RS
    from repro_torch.models.module import tensor_tree
    from repro_torch.models.transformer import lm_init

    lms = dict(LM_VARIANTS)
    mix = lms["mixtral-8x7b"]
    lms["mixtral-8x7b kchoice"] = dataclasses.replace(
        mix, moe=dataclasses.replace(mix.moe, router="irli_kchoice"))
    cases = {}
    for name, cfg in lms.items():
        g = torch.Generator().manual_seed(seed)
        t = torch.randint(0, cfg.vocab, (4, 64), generator=g,
                          dtype=torch.int32)
        cases[name] = (lambda d, cfg=cfg: tensor_tree(lm_init(
            cfg, seed=seed, device=d)),
            S.build_lm_train_step(cfg, "adamw_nomaster", n_micro=2,
                                  lr=1e-3),
            {"tokens": t, "labels": torch.roll(t, -1, 1)})
    r = np.random.default_rng(seed)
    dl = dataclasses.replace(RS.DLRMConfig(), vocab_sizes=(100, 50, 30),
                             n_sparse=3, n_dense=4, embed_dim=8,
                             bot_mlp=(16, 8), top_mlp=(16, 1))
    cases["dlrm"] = (lambda d: RS.dlrm_init(dl, seed=seed, device=d)[0],
                     S.build_ctr_train_step(lambda p, b: RS.dlrm_apply(
                         p, dl, torch.tensor([0, 100, 150], dtype=torch.int32,
                                             device=b["sparse"].device),
                         b["dense"], b["sparse"]), lr=1e-3),
                     {"dense": r.normal(size=(32, 4)).astype(np.float32),
                      "sparse": r.integers(0, 30, (32, 3)).astype(np.int32),
                      "label": r.integers(0, 2, 32).astype(np.float32)})
    bc = RS.BSTConfig(embed_dim=16, seq_len=8, n_blocks=1, n_heads=2,
                      mlp=(32, 8), item_vocab=300, n_other_feats=3,
                      other_vocab=40)
    cases["bst"] = (lambda d: RS.bst_init(bc, seed=seed, device=d),
                    S.build_ctr_train_step(lambda p, b: RS.bst_apply(
                        p, bc, b["hist_items"], b["target_item"],
                        b["other_ids"]), lr=1e-3),
                    {"hist_items": r.integers(0, 300, (8, 8)).astype(
                        np.int32),
                     "target_item": r.integers(0, 300, 8).astype(np.int32),
                     "other_ids": r.integers(0, 40, (8, 3)).astype(
                         np.int32),
                     "label": r.integers(0, 2, 8).astype(np.float32)})
    xc = RS.XDeepFMConfig(n_sparse=5, embed_dim=4, cin_layers=(8, 8),
                          mlp=(16,), vocab_per_field=100)
    cases["xdeepfm"] = (lambda d: RS.xdeepfm_init(xc, seed=seed,
                                                  device=d)[0],
                        S.build_ctr_train_step(lambda p, b: RS.xdeepfm_apply(
                            p, xc, torch.arange(0, 500, 100,
                                                dtype=torch.int32,
                                                device=b["sparse"].device),
                            b["sparse"]), lr=1e-3),
                        {"sparse": r.integers(0, 100, (16, 5)).astype(
                            np.int32),
                         "label": r.integers(0, 2, 16).astype(np.float32)})
    ec = RS.DIENConfig(embed_dim=8, seq_len=12, gru_dim=16, mlp=(16, 8),
                       item_vocab=200, cate_vocab=50)
    cases["dien"] = (lambda d: tensor_tree(RS.dien_init(ec, seed=seed,
                                                        device=d)),
                     S.build_ctr_train_step(lambda p, b: RS.dien_apply(
                         p, ec, b["hist_items"], b["hist_cates"],
                         b["target_item"], b["target_cate"],
                         b["hist_mask"]), lr=1e-3),
                     {"hist_items": r.integers(0, 200, (16, 12)).astype(
                         np.int32),
                      "hist_cates": r.integers(0, 50, (16, 12)).astype(
                          np.int32),
                      "target_item": r.integers(0, 200, 16).astype(np.int32),
                      "target_cate": r.integers(0, 50, 16).astype(np.int32),
                      "hist_mask": (r.random((16, 12)) < 0.8).astype(
                          np.float32),
                      "label": r.integers(0, 2, 16).astype(np.float32)})
    mc = G.SchNetConfig(d_in=0, n_types=10, n_out=1, readout="sum",
                        n_rbf=16, d_hidden=32)
    cases["schnet energy"] = (lambda d: G.schnet_init(mc, seed=seed,
                                                      device=d),
                              S.build_gnn_energy_train(mc, 8, lr=1e-3),
                              molecule_batch(8, 6, 12, seed=seed))
    nc = G.SchNetConfig(d_in=32, n_out=7, readout="none", n_rbf=16,
                        d_hidden=32)
    cases["schnet node"] = (lambda d: G.schnet_init(nc, seed=seed,
                                                    device=d),
                            S.build_gnn_node_train(nc, lr=1e-3),
                            {"feats": r.normal(size=(50, 32)).astype(
                                np.float32),
                             "src": r.integers(0, 50, 200).astype(np.int32),
                             "dst": r.integers(0, 50, 200).astype(np.int32),
                             "dist": r.uniform(0, 8, 200).astype(np.float32),
                             "labels": r.integers(0, 7, 50).astype(np.int32),
                             "node_mask": (r.random(50) < 0.9).astype(
                                 np.float32)})
    return cases
