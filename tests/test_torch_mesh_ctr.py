"""The registry's CTR, retrieval and SchNet steps on DTensors over 4 gloo
ranks (data 2 x model 2) against the same steps without a mesh, and
DLRM's mesh step against ``jax.value_and_grad`` of the reference's loss.

``tests/torch_mesh_ctr_ranks.ctr_ranks`` runs the mesh side (every case
once, in one spawned world) at narrow widths whose tables have odd row
counts, so that the blocks of a row-sharded table are uneven and the
batches' ids hit every block. Here the same params and batches go through
the meshless steps. A train step is held by its loss, every gradient leaf
(AdamW's first moment / 0.1 after one step), the second moment and the
params after it (``torch_grad_check``'s rules), each gradient leaf to
1e-4 of its largest value; a serve step's
prob to 1e-5; the retrieval's ids exactly (a tie across two blocks goes to
the smaller id) and its scores to 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_ranks as R  # noqa: E402
import torch_mesh_ctr_ranks as CR  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro_torch.data.synthetic import molecule_batch  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import gnn as G  # noqa: E402
from repro_torch.models import recsys as RS  # noqa: E402
from repro_torch.models.module import tensor_tree  # noqa: E402

from torch_grad_check import (ZERO_LEAF, assert_grads,  # noqa: E402
                              assert_step)

jax.config.update("jax_platforms", "cpu")

CTR = ("dlrm", "bst", "xdeepfm", "dien")


def _dlrm_reference_params():
    jc = dataclasses.replace(JR.DLRMConfig(), **CR.DLRM)
    jp, joff = JR.dlrm_init(jax.random.PRNGKey(0), jc)
    return jc, jax.device_get(jp), np.asarray(joff)


def _params() -> dict:
    """Each case's whole params as numpy: DLRM's from the reference's
    draws, the others from the port's init."""
    _, jp, _ = _dlrm_reference_params()
    out = {"dlrm": jax.tree.map(np.asarray, jp),
           "bst": RS.bst_init(RS.BSTConfig(**CR.BST), seed=0, device="cpu"),
           "xdeepfm": RS.xdeepfm_init(RS.XDeepFMConfig(**CR.XDEEPFM),
                                      seed=0, device="cpu")[0],
           "dien": tensor_tree(RS.dien_init(RS.DIENConfig(**CR.DIEN),
                                            seed=0, device="cpu"))}
    node_cfg, mol_cfg = CR.schnet_cfgs()
    out["node"] = G.schnet_init(node_cfg, seed=1, device="cpu")
    out["molecule"] = G.schnet_init(mol_cfg, seed=2, device="cpu")
    return {k: _numpy(v) for k, v in out.items()}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy().copy()
    return np.asarray(tree)


def _batches() -> dict:
    """Each case's batch: ids drawn over each table's whole range, so
    every block of a row-sharded table is read."""
    rng = np.random.default_rng(0)
    B = CR.ROWS
    vs = CR.DLRM["vocab_sizes"]
    out = {"dlrm": {
        "dense": rng.normal(size=(B["dlrm"], 4)).astype(np.float32),
        "sparse": np.stack([rng.integers(0, v, B["dlrm"]) for v in vs],
                           1).astype(np.int32),
        "label": rng.integers(0, 2, B["dlrm"]).astype(np.float32)}}
    bv, T = CR.BST["item_vocab"], CR.BST["seq_len"]
    out["bst"] = {
        "hist_items": rng.integers(0, bv, (B["bst"], T)).astype(np.int32),
        "target_item": rng.integers(0, bv, B["bst"]).astype(np.int32),
        "other_ids": rng.integers(0, 40, (B["bst"], 3)).astype(np.int32),
        "label": rng.integers(0, 2, B["bst"]).astype(np.float32)}
    out["xdeepfm"] = {
        "sparse": rng.integers(0, CR.XDEEPFM["vocab_per_field"],
                               (B["xdeepfm"], 5)).astype(np.int32),
        "label": rng.integers(0, 2, B["xdeepfm"]).astype(np.float32)}
    ev, T = CR.DIEN["item_vocab"], CR.DIEN["seq_len"]
    out["dien"] = {
        "hist_items": rng.integers(0, ev, (B["dien"], T)).astype(np.int32),
        "hist_cates": rng.integers(0, 50, (B["dien"], T)).astype(np.int32),
        "target_item": rng.integers(0, ev, B["dien"]).astype(np.int32),
        "target_cate": rng.integers(0, 50, B["dien"]).astype(np.int32),
        "hist_mask": (rng.random((B["dien"], T)) < 0.8).astype(np.float32),
        "label": rng.integers(0, 2, B["dien"]).astype(np.float32)}
    N, E = CR.NODE_N, CR.NODE_E
    out["node"] = {
        "feats": rng.normal(size=(N, CR.NODE_D)).astype(np.float32),
        "src": rng.integers(0, N, E).astype(np.int32),
        "dst": rng.integers(0, N, E).astype(np.int32),
        "dist": rng.uniform(0, 12, E).astype(np.float32),
        "labels": rng.integers(0, 5, N).astype(np.int32),
        "node_mask": (rng.random(N) < 0.8).astype(np.float32)}
    mol = molecule_batch(CR.MOL_G, CR.MOL_N, CR.MOL_E, seed=0)
    perm = rng.permutation(mol["src"].shape[0])   # edge blocks != node blocks
    for k in ("src", "dst", "dist"):
        mol[k] = mol[k][perm]
    out["molecule"] = mol
    return out


def _retrieval():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(CR.RET_N, CR.RET_D)).astype(np.float32)
    query = rng.normal(size=(CR.RET_Q, CR.RET_D)).astype(np.float32)
    table[CR.TIE_A] = query[0] * 4          # the first two of query 0 ...
    table[CR.TIE_B] = table[CR.TIE_A]       # ... tie across blocks 0 and 1
    table[300] = table[7]                   # and a tie lower down
    return table, query


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ctr")
    params, batches = _params(), _batches()
    table, query = _retrieval()
    arrays = {"retrieval|table": table, "retrieval|query": query}
    for name in (*CTR, "node", "molecule"):
        arrays.update(CR.flat(params[name], f"{name}|params"))
        arrays.update(CR.flat(batches[name], f"{name}|batch"))
    np.savez(tmp / "mesh_ctr_in.npz", **arrays)
    R.spawn(CR.ctr_ranks, 4, tmp, timeout=240.0)
    return (np.load(tmp / "mesh_ctr_out.npz"), params, batches,
            (table, query))


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _meshless_train(step, opt, params, batch) -> dict:
    p = _tensors(params)
    state, metrics = step({"params": p, "opt": opt.init(p)},
                          _tensors(batch))
    return {"loss": float(metrics["loss"]),
            "params": _numpy(state["params"]),
            "m": _numpy(state["opt"]["m"]), "v": _numpy(state["opt"]["v"])}


def _hold_train(out, name: str, want: dict, tol: float = 1e-4) -> None:
    """The mesh step's loss, gradient (m / 0.1), second moment and params
    against the meshless step's (``torch_grad_check``'s rules: a leaf
    whose exact gradient is 0 is held to the tree's scale)."""
    got = CR.split(out, f"{name}|train")
    assert abs(float(got["loss"]) - want["loss"]) <= tol * abs(want["loss"])
    grad = lambda m: jax.tree.map(lambda a: a / 0.1, m)  # noqa: E731
    assert_grads(grad(got["m"]), grad(want["m"]), tol=tol)
    assert_grads(got["v"], want["v"], tol=tol, zero_leaf=ZERO_LEAF ** 2)
    assert_step(got["params"], want["params"], grad(want["m"]), CR.LR)


@pytest.mark.parametrize("name", CTR)
def test_ctr_train_step_on_a_mesh(world, name):
    """The train_batch cell's step (rows over "data", the tables split on
    their rows over both axes, uneven blocks) against the meshless step:
    loss, every gradient leaf, AdamW's moments and the params after one
    step, each to 1e-4."""
    out, params, batches, _ = world
    apply_fn, _ = CR.cases()[name]
    step, opt = S.build_ctr_train_step(apply_fn, lr=CR.LR)
    _hold_train(out, name, _meshless_train(step, opt, params[name],
                                           batches[name]))


@pytest.mark.parametrize("layout", ["p99", "bulk"])
@pytest.mark.parametrize("name", CTR)
def test_ctr_serve_on_a_mesh(world, name, layout):
    """The serve cells' step in both layouts (serve_p99: rows over "data";
    serve_bulk: over every axis): prob to 1e-5 of the meshless serve.
    DIEN's item history sum is the embedding_bag plain version on each
    rank's block."""
    out, params, batches, _ = world
    apply_fn, _ = CR.cases()[name]
    want = S.build_ctr_serve(apply_fn)(_tensors(params[name]),
                                       _tensors(batches[name]))["prob"]
    np.testing.assert_allclose(out[f"{name}|prob_{layout}"], want.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_retrieval_on_a_row_sharded_table(world):
    """retrieval_cand's step over an item table split on its rows (403
    rows: blocks of 101, 101, 101, 100): the ids equal the meshless
    step's, a tie across blocks 0 and 1 going to the smaller id, and the
    scores to 1e-5."""
    out, _, _, (table, query) = world
    want = S.build_retrieval_serve(CR.RET_K)(
        {"item_table": {"table": torch.from_numpy(table)}},
        {"query": torch.from_numpy(query)})
    np.testing.assert_array_equal(out["retrieval|ids"], want["ids"].numpy())
    assert list(out["retrieval|ids"][0, :2]) == [CR.TIE_A, CR.TIE_B]
    np.testing.assert_allclose(out["retrieval|scores"],
                               want["scores"].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["node", "node_whole", "molecule"])
def test_schnet_on_node_and_edge_shards(world, name):
    """SchNet's node step with nodes and edges split over both axes (edges
    crossing the node blocks), and whole on every rank (full_graph_sm's
    layout), and the molecule energy step (its edges shuffled across the
    node blocks): one step each, held to the meshless step to 1e-4."""
    out, params, batches, _ = world
    node_cfg, mol_cfg = CR.schnet_cfgs()
    src = "node" if name == "node_whole" else name
    step, opt = (S.build_gnn_energy_train(mol_cfg, CR.MOL_G, lr=CR.LR)
                 if name == "molecule"
                 else S.build_gnn_node_train(node_cfg, lr=CR.LR))
    _hold_train(out, name, _meshless_train(step, opt, params[src],
                                           batches[src]))


def test_dlrm_mesh_step_against_the_reference(world):
    """DLRM's mesh loss and gradient (AdamW's first moment / 0.1) at the
    reference's draws against ``jax.value_and_grad`` of its mean stable
    BCE, each leaf to 1e-4."""
    out, _, batches, _ = world
    jc, jp, joff = _dlrm_reference_params()
    b = {k: jnp.asarray(v) for k, v in batches["dlrm"].items()}
    loss, g = jax.value_and_grad(lambda p: jnp.mean(
        JL.stable_bce_with_logits(JR.dlrm_apply(
            p, jc, jnp.asarray(joff), b["dense"], b["sparse"]),
            b["label"])))(jp)
    got = CR.split(out, "dlrm|train")
    assert abs(float(got["loss"]) - float(loss)) <= 1e-4 * abs(float(loss))
    assert_grads(jax.tree.map(lambda a: a / 0.1, got["m"]),
                 jax.tree.map(np.asarray, g), tol=1e-4)
