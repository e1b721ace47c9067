"""The port's CTR and GNN training paths, their data and the training
launcher against the JAX package on the CPU.

The same numpy inputs (from a seed) go through ``repro`` and its
counterpart in ``repro_torch``: ``segment_softmax`` and
``stable_bce_with_logits`` (1e-6, at logits of ±80 and with an empty
segment); DLRM, BST, xDeepFM and DIEN through ``build_ctr_train_step`` and
SchNet through both GNN steps, at ``tests/test_smoke_archs.py``'s tiny
configs, from the JAX draws (``convert``); ``schnet_apply``'s forward at
node and graph readout; ``criteo_stream``, ``random_graph``,
``molecule_batch`` and ``NeighborSampler.sample`` equal to the reference's
arrays exactly; and ``repro_torch.launch.train.main`` for each of the
seven model archs with ``--device cpu``, then a resume. A train step is
held as in ``torch_grad_check``: loss and grad_norm to 1e-5, the gradient
(recovered from AdamW's first moment) to 1e-5 of each leaf's largest |g|,
the updated params under the sign rule.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import sampler as JSMP  # noqa: E402
from repro.data import synthetic as JD  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import gnn as JG  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import sampler as PSMP  # noqa: E402
from repro_torch.data import synthetic as PD  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.launch import steps as PS  # noqa: E402
from repro_torch.launch import train as PTR  # noqa: E402
from repro_torch.models import gnn as PG  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import recsys as PR  # noqa: E402
from repro_torch.models.module import tensor_tree  # noqa: E402

from torch_grad_check import (ZERO_LEAF, _np, assert_grads,  # noqa: E402
                              assert_step)

jax.config.update("jax_platforms", "cpu")

LR = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    """These models are tiny: one intra-op thread runs them fastest and
    keeps a worker from oversubscribing the cores it shares with the
    others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- segment ops --
def test_segment_softmax_matches_reference():
    """Logits at ±80, segments of one, an empty segment (id 5 unused),
    unsorted ids: to 1e-6."""
    rng = np.random.default_rng(0)
    scores = rng.normal(size=40).astype(np.float32) * 4
    scores[:4] = [80.0, -80.0, 79.5, -79.0]
    seg = rng.integers(0, 8, 40).astype(np.int32)
    seg[seg == 5] = 6
    seg[10] = 7                                  # 7 may hold a single edge
    got = PL.segment_softmax(torch.from_numpy(scores), torch.from_numpy(seg),
                             9)
    want = JL.segment_softmax(jnp.asarray(scores), jnp.asarray(seg), 9)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)


def test_stable_bce_with_logits_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=64).astype(np.float32) * 10
    x[:6] = [80.0, -80.0, 0.0, 1e-8, -30.0, 30.0]
    y = rng.integers(0, 2, 64).astype(np.float32)
    got = PL.stable_bce_with_logits(torch.from_numpy(x), torch.from_numpy(y))
    want = JL.stable_bce_with_logits(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)
    gx = torch.from_numpy(x).requires_grad_(True)
    PL.stable_bce_with_logits(gx, torch.from_numpy(y)).sum().backward()
    jg = jax.grad(lambda a: jnp.sum(JL.stable_bce_with_logits(
        a, jnp.asarray(y))))(jnp.asarray(x))
    np.testing.assert_allclose(gx.grad.numpy(), _np(jg), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------------- the steps --
def _hold_step(jstep, jopt, jparams, pstep, pparams, batch, tree_to):
    """One AdamW step in both packages from the same params and batch:
    loss, grad_norm, gradient (from m), v and params. Launches nothing."""
    jstate = {"params": jparams, "opt": jopt.init(jparams)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jnew, jm = jax.jit(jstep)(jstate, jbatch)
    jnew = jax.device_get(jnew)
    popt = convert.adamw_state_from_reference(jax.device_get(jstate["opt"]),
                                              device="cpu")
    reset_launches()
    pnew, pm = pstep({"params": pparams, "opt": popt}, batch)
    assert sum(LAUNCHES.values()) == 0
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    back = convert.adamw_state_to_reference(pnew["opt"], tree_to)
    g_ref = jax.tree.map(lambda m: _np(m) / 0.1, jnew["opt"]["m"])
    assert_grads(jax.tree.map(lambda m: _np(m) / 0.1, back["m"]), g_ref)
    assert_grads(back["v"], jnew["opt"]["v"], zero_leaf=ZERO_LEAF ** 2)
    assert_step(tree_to(pnew["params"]), jnew["params"], g_ref, LR)
    return pm


def _dlrm():
    cfg = dict(vocab_sizes=(100, 50, 30), n_sparse=3, n_dense=4,
               embed_dim=8, bot_mlp=(16, 8), top_mlp=(16, 1))
    jc = dataclasses.replace(JR.DLRMConfig(), **cfg)
    pc = dataclasses.replace(PR.DLRMConfig(), **cfg)
    jp, joff = JR.dlrm_init(jax.random.PRNGKey(0), jc)
    B = 32
    batch = {"dense": np.random.default_rng(0).normal(size=(B, 4)).astype(
                 np.float32),
             "sparse": np.random.default_rng(1).integers(0, 30, (B, 3)
                                                         ).astype(np.int32),
             "label": np.random.default_rng(2).integers(0, 2, B).astype(
                 np.float32)}
    poff = torch.from_numpy(np.array(joff))
    return (jp, lambda p, b: JR.dlrm_apply(p, jc, joff, b["dense"],
                                           b["sparse"]),
            lambda p, b: PR.dlrm_apply(p, pc, poff, b["dense"], b["sparse"]),
            batch)


def _bst():
    cfg = dict(embed_dim=16, seq_len=8, n_blocks=1, n_heads=2, mlp=(32, 8),
               item_vocab=300, n_other_feats=3, other_vocab=40)
    jc, pc = JR.BSTConfig(**cfg), PR.BSTConfig(**cfg)
    rng = np.random.default_rng(0)
    B = 8
    batch = {"hist_items": rng.integers(0, 300, (B, 8)).astype(np.int32),
             "target_item": rng.integers(0, 300, B).astype(np.int32),
             "other_ids": rng.integers(0, 40, (B, 3)).astype(np.int32),
             "label": rng.integers(0, 2, B).astype(np.float32)}
    return (JR.bst_init(jax.random.PRNGKey(0), jc),
            lambda p, b: JR.bst_apply(p, jc, b["hist_items"],
                                      b["target_item"], b["other_ids"]),
            lambda p, b: PR.bst_apply(p, pc, b["hist_items"],
                                      b["target_item"], b["other_ids"]),
            batch)


def _xdeepfm():
    cfg = dict(n_sparse=5, embed_dim=4, cin_layers=(8, 8), mlp=(16,),
               vocab_per_field=100)
    jc, pc = JR.XDeepFMConfig(**cfg), PR.XDeepFMConfig(**cfg)
    jp, joff = JR.xdeepfm_init(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(0)
    B = 16
    batch = {"sparse": rng.integers(0, 100, (B, 5)).astype(np.int32),
             "label": rng.integers(0, 2, B).astype(np.float32)}
    poff = torch.from_numpy(np.array(joff))
    return (jp, lambda p, b: JR.xdeepfm_apply(p, jc, jnp.asarray(joff),
                                              b["sparse"]),
            lambda p, b: PR.xdeepfm_apply(p, pc, poff, b["sparse"]), batch)


def _dien():
    cfg = dict(embed_dim=8, seq_len=12, gru_dim=16, mlp=(16, 8),
               item_vocab=200, cate_vocab=50)
    jc, pc = JR.DIENConfig(**cfg), PR.DIENConfig(**cfg)
    rng = np.random.default_rng(0)
    B = 16
    batch = {"hist_items": rng.integers(0, 200, (B, 12)).astype(np.int32),
             "hist_cates": rng.integers(0, 50, (B, 12)).astype(np.int32),
             "target_item": rng.integers(0, 200, B).astype(np.int32),
             "target_cate": rng.integers(0, 50, B).astype(np.int32),
             "hist_mask": (rng.random((B, 12)) < 0.8).astype(np.float32),
             "label": rng.integers(0, 2, B).astype(np.float32)}
    keys = ("hist_items", "hist_cates", "target_item", "target_cate",
            "hist_mask")
    return (JR.dien_init(jax.random.PRNGKey(0), jc),
            lambda p, b: JR.dien_apply(p, jc, *(b[k] for k in keys)),
            lambda p, b: PR.dien_apply(p, pc, *(b[k] for k in keys)),
            batch)


CTR = {"dlrm": _dlrm, "bst": _bst, "xdeepfm": _xdeepfm, "dien": _dien}


@pytest.mark.parametrize("arch", list(CTR))
def test_ctr_train_step_matches_reference(arch):
    """One ``build_ctr_train_step`` step (mean stable BCE, adamw_nomaster)
    from the JAX draws. DIEN's history sum takes the reference's masked
    sum under the gradient (the table rows' share reaches the tables)."""
    jp, japply, papply, batch = CTR[arch]()
    jstep, jopt = JS.build_ctr_train_step(japply, lr=LR)
    pstep, _ = PS.build_ctr_train_step(papply, lr=LR)
    pp = convert.tree_from_reference(jax.device_get(jp), device="cpu")
    pm = _hold_step(jstep, jopt, jp, pstep, pp, batch,
                    convert.tree_to_reference)
    assert float(pm["bce"]) == float(pm["loss"])


def test_dien_module_params_train_as_their_tree():
    """DIEN's params from ``dien_init`` (a module) train through their
    ``tensor_tree`` in place: the module's own tables move."""
    cfg = PR.DIENConfig(embed_dim=8, seq_len=12, gru_dim=16, mlp=(16, 8),
                        item_vocab=200, cate_vocab=50)
    model = PR.dien_init(cfg, seed=0, device="cpu")
    before = model["item_emb"]["table"].detach().clone()
    _, _, papply, batch = _dien()
    papply = lambda p, b: PR.dien_apply(  # noqa: E731
        p, cfg, b["hist_items"], b["hist_cates"], b["target_item"],
        b["target_cate"], b["hist_mask"])
    step, opt = PS.build_ctr_train_step(papply, lr=LR)
    tree = tensor_tree(model)
    step({"params": tree, "opt": opt.init(tree)}, batch)
    rows = np.unique(batch["hist_items"][batch["hist_mask"] > 0])
    moved = (model["item_emb"]["table"] - before).abs().sum(1)
    assert bool((moved[torch.from_numpy(rows).long()] > 0).all())


# ------------------------------------------------------------------ GNN ----
def test_schnet_forward_node_and_graph_readout():
    rng = np.random.default_rng(0)
    N, E = 50, 200
    feats = rng.normal(size=(N, 32)).astype(np.float32)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    dist = rng.uniform(0, 12, E).astype(np.float32)     # some past cutoff
    gids = np.sort(rng.integers(0, 4, N)).astype(np.int32)
    for readout, n_out in (("none", 7), ("sum", 1)):
        jc = JG.SchNetConfig(d_in=32, n_out=n_out, readout=readout, n_rbf=16,
                             d_hidden=32)
        pc = PG.SchNetConfig(**dataclasses.asdict(jc))
        jp = JG.schnet_init(jax.random.PRNGKey(0), jc)
        pp = convert.schnet_params_from_reference(jax.device_get(jp),
                                                  device="cpu")
        extra = {} if readout == "none" else dict(n_graphs=4)
        want = jax.jit(lambda p, *a, g, jc=jc, extra=extra: JG.schnet_apply(
            p, jc, *a, graph_ids=g, **extra))(
                jp, *(jnp.asarray(a) for a in (feats, src, dst, dist)),
                g=None if readout == "none" else jnp.asarray(gids))
        got = PG.schnet_apply(pp, pc, *(torch.from_numpy(a) for a in
                                        (feats, src, dst, dist)),
                              graph_ids=(None if readout == "none"
                                         else torch.from_numpy(gids)),
                              **extra)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-5)


def test_schnet_energy_train_step_matches_reference():
    jc = JG.SchNetConfig(d_in=0, n_types=10, n_out=1, readout="sum",
                         n_rbf=16, d_hidden=32)
    pc = PG.SchNetConfig(**dataclasses.asdict(jc))
    batch = PD.molecule_batch(batch=8, n_nodes=6, n_edges=12, seed=0)
    jstep, jopt = JS.build_gnn_energy_train(jc, 8, lr=LR)
    pstep, _ = PS.build_gnn_energy_train(pc, 8, lr=LR)
    jp = JG.schnet_init(jax.random.PRNGKey(0), jc)
    pp = convert.schnet_params_from_reference(jax.device_get(jp),
                                              device="cpu")
    pm = _hold_step(jstep, jopt, jp, pstep, pp, batch,
                    convert.schnet_params_to_reference)
    assert float(pm["mse"]) == float(pm["loss"])


def test_schnet_node_train_step_on_a_sampled_subgraph():
    """The fanout sampler's padded subgraph (masked nodes, padded edges
    beyond the cutoff) through ``build_gnn_node_train`` in both
    packages."""
    g = PD.random_graph(500, 3000, d_feat=16, seed=0, n_classes=5)
    csr = PSMP.build_csr(500, g["src"], g["dst"], pos=g["pos"])
    sub = PSMP.NeighborSampler(csr, fanouts=(3, 2), batch_nodes=16,
                               seed=0).sample()
    batch = {"feats": g["feats"][sub["nodes"]], "src": sub["src"],
             "dst": sub["dst"], "dist": sub["dist"],
             "labels": g["labels"][sub["nodes"]],
             "node_mask": sub["node_mask"]}
    jc = JG.SchNetConfig(d_in=16, n_out=5, readout="none", n_rbf=8,
                         d_hidden=16)
    pc = PG.SchNetConfig(**dataclasses.asdict(jc))
    jstep, jopt = JS.build_gnn_node_train(jc, 5, lr=LR)
    pstep, _ = PS.build_gnn_node_train(pc, lr=LR)
    jp = JG.schnet_init(jax.random.PRNGKey(0), jc)
    pp = convert.schnet_params_from_reference(jax.device_get(jp),
                                              device="cpu")
    pm = _hold_step(jstep, jopt, jp, pstep, pp, batch,
                    convert.schnet_params_to_reference)
    assert float(pm["nll"]) == float(pm["loss"])


# ----------------------------------------------------------------- data ----
def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_criteo_stream_equals_reference():
    vocab = (1000, 3, 40_000_000, 17)
    got, want = (PD.criteo_stream(64, 13, vocab, seed=5),
                 JD.criteo_stream(64, 13, vocab, seed=5))
    for _ in range(2):
        _equal(next(got), next(want))


def test_random_graph_and_molecule_batch_equal_reference():
    _equal(PD.random_graph(300, 2000, 12, seed=3, n_classes=7),
           JD.random_graph(300, 2000, 12, seed=3, n_classes=7))
    _equal(PD.molecule_batch(9, 7, 15, seed=4),
           JD.molecule_batch(9, 7, 15, seed=4))


def test_neighbor_sampler_equals_reference():
    g = JD.random_graph(800, 6000, 4, seed=1)
    jc = JSMP.build_csr(800, g["src"], g["dst"], pos=g["pos"])
    pc = PSMP.build_csr(800, g["src"], g["dst"], pos=g["pos"])
    for f in ("indptr", "indices", "pos"):
        np.testing.assert_array_equal(getattr(pc, f), getattr(jc, f))
    js = JSMP.NeighborSampler(jc, (15, 10), 32, seed=2)
    ps = PSMP.NeighborSampler(pc, (15, 10), 32, seed=2)
    assert (ps.max_nodes, ps.max_edges) == (js.max_nodes, js.max_edges)
    for _ in range(2):
        _equal(ps.sample(), js.sample())
    # positions drawn when none are given
    np.testing.assert_array_equal(
        PSMP.build_csr(50, g["src"][:90] % 50, g["dst"][:90] % 50).pos,
        JSMP.build_csr(50, g["src"][:90] % 50, g["dst"][:90] % 50).pos)


# ------------------------------------------------------------- launcher ----
ARCHS = [*PTR.LM_ARCHS, "schnet", "dlrm"]


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_runs_and_resumes(arch, tmp_path, capsys):
    """``main`` runs the branch and prints its line (``--steps 2``); a run
    to ``--steps 3`` resumes from its checkpoint (resumed=True, 1 step)
    and its loss equals a straight 3-step run's: every batch is a
    function of its step, the state restored whole; run again it says the
    run is complete."""
    base = ["--arch", arch, "--device", "cpu"]

    def run(argv):
        return PTR.run_model(PTR.parse(argv))
    assert PTR.main(base + ["--steps", "2", "--ckpt",
                            str(tmp_path / "a")]) is None
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"{arch}: 2 steps, loss ")
    assert line.endswith("resumed=False")
    out = run(base + ["--steps", "3", "--ckpt", str(tmp_path / "a")])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"{arch}: 1 steps, loss ")
    assert line.endswith("resumed=True")
    straight = run(base + ["--steps", "3", "--ckpt", str(tmp_path / "b")])
    assert all(np.isfinite(m["loss"]) for m in straight["metrics"])
    assert out["metrics"][-1]["loss"] == straight["metrics"][-1]["loss"]
    again = run(base + ["--steps", "3", "--ckpt", str(tmp_path / "a")])
    assert "already complete" in capsys.readouterr().out
    assert again["metrics"] == []
